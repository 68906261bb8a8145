"""Training jobs, one module a learning type, found by the ``job`` key of
a traffic file.  A job owns everything of its learning type that the
harness drives; the harness calls, by these names:

Program side
  ``param_spec(model, cfg, n)``  the leaves the reference draws and the
      program is loaded with (the reference model's, and any head the
      job trains);
  ``leaves(trainer)``  {name: parameter} of what the optimizer steps;
  ``learn(trainer, args, epochs, seed)``  the engine call the window
      drives (its result has ``losses`` and ``epoch_seconds``);
  ``recorder(log)``  records the job's draws into the dict ``log``;
  ``watch(log)``  keeps, around the window, what the job checks of the
      window's own draws, at no cost to it (no copy, no launch);
  ``records(log, steps)``  the recorded checked steps on the host:
      ``steps`` (a list of batches a step, each a dict), ``embs`` (the
      first forward's embeddings) and whatever the job checks later;
  ``trace_ranges(ranges)``  brackets the job's loss for the traced run;
  ``half()``  the fault that leaves out half of each batch.
Reference side
  ``reference_inputs(cell, adjs, seed, device, prog, steps)``  (the
      job's tables for ``follow``, {exact check: count}, {statistic:
      value});
  ``follow(model, cfg, traffic, prep, tables, params0, steps)``  the
      reference's steps;
  ``flops(model, prep, cfg, traffic)``  the FLOPs of one epoch."""
