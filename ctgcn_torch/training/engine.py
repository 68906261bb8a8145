# coding: utf-8
"""Training engines (port of ``ctgcn_tpu/training/engine.py``).

``UnsupervisedEmbedding`` (U-neg, U-own): every epoch splits the nodes
into batches; each batch re-runs the whole window forward and adds its
loss gradient to the parameters' ``.grad``, and one optimizer step follows
the epoch (gradient accumulation, as the JAX engine's batch scan does).
With ``state_init`` (VGRNN) the loss is stateful: a state made at every
epoch's start crosses the epoch's batches detached, as the JAX engine's
``stop_gradient`` carry does, and the export replays that carry.

``SupervisedEmbedding`` (S-node, S-edge, S-link-st, S-link-dy): every
epoch is one full-batch step of the model and its classifier over the
train split, then a forward over the validation split; the parameters of
the best validation accuracy are kept, saved, tested and exported.  The
train step's forward draws from a generator seeded with the window's seed,
the others from none, as the JAX engine passes no key to its evaluation
step.  With ``state_init`` (VGRNN) the forward is stateful: the state is
made at every epoch's start, flows from the train step to the validation
forward, is kept with the best parameters and feeds the test forward,
whose embeddings are exported.

The optimizer is ``torch.optim.Adam(lr, weight_decay=wd)``: L2 added to
the gradient before the moment updates, eps 1e-8 -- the same update as
the JAX package's ``optax.chain(add_decayed_weights, scale_by_adam,
scale(-lr))``.  optax updates every leaf, so a parameter that no loss
reached (PGNN's first position head) gets a zero gradient before each
step and its weight decay still moves it; torch's Adam would skip it.
Parameters are saved as the flax msgpack the JAX package's
``save_params`` writes (``save_model_file``: ``interop.params_to_numpy``,
``model_file.write_flax_msgpack``), so either package's ``load_model:
true`` reads the other's files; ``load_model_file`` reads that format and
the ``torch.save`` archives earlier versions of the port wrote.

Under several parts (``parallel.mesh.Sharding``, every learning type):
every part draws the same batches, negatives and dropout from the same
seeded generators, the gradients are reduced by the sharding's rule before
each optimizer step (a classifier's averaged: it is used after the
gather), rank 0 alone writes the CSVs and the model files, and the model
file is the whole model's (time-stacked slices gathered first): the
single-device file's bytes, so ``load_model_file`` reads either.  The
supervised trainer keeps the best-on-validation parameters when part 0
says so: every part makes that choice together.
"""
from __future__ import annotations

import copy
import os
import time
import zipfile

import numpy as np
import torch

from ctgcn_torch.data.formats import write_embedding_csvs
from ctgcn_torch.interop import params_from_numpy, params_to_numpy
from ctgcn_torch.parallel.dist import is_primary, part0_flag
from ctgcn_torch.training.model_file import (flax_msgpack_parts,
                                             read_flax_msgpack)
from ctgcn_torch.training.profiling import (EpochTracer, PhaseClock, count,
                                            span, traced_if_profiled)
from ctgcn_torch.utils import check_and_make_path


def batch_matrix(node_num, batch_size, rng=None, shuffle=True):
    """Split node ids into a padded [batch_num, batch_size] matrix + mask.

    ``rng``: numpy ``Generator`` for the permutation (``shuffle``)."""
    order = np.arange(node_num)
    if shuffle:
        order = (rng if rng is not None else np.random).permutation(node_num)
    batch_num = -(-node_num // batch_size)
    padded = np.zeros(batch_num * batch_size, np.int64)
    mask = np.zeros(batch_num * batch_size, bool)
    padded[:node_num] = order
    mask[:node_num] = True
    return (padded.reshape(batch_num, batch_size),
            mask.reshape(batch_num, batch_size))


def read_model_file(path, device="cpu"):
    """The ``state_dict`` saved at ``path``, on ``device``: flax msgpack
    (what either package writes at ``<base>/<model_folder>/<model_file>``;
    decoded by ``model_file.read_flax_msgpack``, mapped by
    ``interop.params_from_numpy``) or a ``torch.save`` archive of a
    ``state_dict`` (what the port wrote before it wrote msgpack).  Raises
    ``ValueError`` naming ``path`` for a file that is neither; it does not
    fall back to a fresh model."""
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location=device)
    with open(path, "rb") as fp:
        buf = fp.read()
    try:
        tree = read_flax_msgpack(buf)
    except ValueError as exc:
        raise ValueError(
            f"{path} is not a model file: neither a torch.save archive "
            f"of a state_dict nor flax msgpack ({exc}); remove it, or "
            "set load_model to false") from None
    return {k: v.to(device) for k, v in params_from_numpy(tree).items()}


def load_model_file(model, path, device, sharding=None):
    """Load the parameters saved at ``path`` (``read_model_file``) into
    ``model``, into its slice through ``sharding`` when it is split."""
    state = read_model_file(path, device)
    if sharding is None:
        model.load_state_dict(state)
    else:
        sharding.load_state_dict(model, state)


def save_model_file(model, path, sharding=None):
    """Write ``model``'s parameters at ``path`` as the JAX package's
    ``save_params`` writes the JAX model of the same name: flax msgpack of
    its ``to_state_dict`` tree, float32 leaves.  Split over parts, the
    whole model's parameters are gathered through ``sharding`` (a
    collective: every part calls it) and rank 0 writes."""
    state = (model.state_dict() if sharding is None
             else sharding.state_dict(model))
    if not is_primary():
        return
    parts = flax_msgpack_parts(params_to_numpy(state, type(model).__name__))
    with open(path, "wb") as fp:
        fp.writelines(parts)


class _Adam(torch.optim.Adam):
    """``torch.optim.Adam`` over every parameter, each without a gradient
    given zeros first (optax's update of every leaf)."""

    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None and p.requires_grad:
                    p.grad = torch.zeros_like(p)
        return super().step(closure)


def make_optimizer(params, lr, weight_decay=0.0):
    return _Adam(params, lr=lr, weight_decay=weight_decay, eps=1e-8)


class BaseEmbedding:
    """What both trainers share: the artifact paths, the window's inputs
    and the embedding CSV export.

    Args:
      model: ``nn.Module`` on ``device``.
      embed_fn: (model, data) -> [T, N, d] embeddings for export.
      data: the window's inputs on ``device``.
    """

    def __init__(self, base_path, origin_folder, embedding_folder, node_list,
                 model, embed_fn, data, device, model_folder="model",
                 file_sep="\t"):
        self.origin_base_path = os.path.abspath(
            os.path.join(base_path, origin_folder))
        self.embedding_base_path = os.path.abspath(
            os.path.join(base_path, embedding_folder))
        self.model_base_path = os.path.abspath(
            os.path.join(base_path, model_folder))
        self.model = model
        self.embed_fn = embed_fn
        self.data = data
        self.device = torch.device(device)
        self.file_sep = file_sep
        self.full_node_list = node_list
        self.node_num = len(node_list)
        self.sharding = None
        self.timestamp_list = sorted(os.listdir(self.origin_base_path))
        check_and_make_path(self.embedding_base_path)
        check_and_make_path(self.model_base_path)

    def save_embedding(self, output, start_idx):
        """output [T, N, d] (or [N, d]) -> one CSV per timestamp, named
        after the snapshot file, node names as the index (formatted in
        worker processes when large: ``write_embedding_csvs``)."""
        arr = output.detach().float().cpu().numpy()
        if arr.ndim == 2:
            arr = arr[None]
        paths = [os.path.join(self.embedding_base_path,
                              self.timestamp_list[start_idx + i].split(".")[0]
                              + ".csv") for i in range(arr.shape[0])]
        write_embedding_csvs(paths, list(arr), self.full_node_list,
                             sep=self.file_sep)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class UnsupervisedEmbedding(BaseEmbedding):
    """U-neg / U-own trainer with embedding CSV export.

    Args:
      loss_fn: (model, data, batch_idx[B], batch_mask[B], generator) ->
        scalar tensor; with ``state_init``, (..., generator, state) ->
        (scalar tensor, new state).
      state_init: optional (model, data) -> the state of an epoch's first
        batch; each later batch gets the one before's new state, detached.
      embed_state_fn: optional (model, data, state or None) -> (output, new
        state): with more than one batch the export runs it once a batch
        from ``None``, carrying the state, and exports the last output (the
        final epoch's last batch forward); with one batch ``embed_fn``.
      sharding: optional ``parallel.mesh.Sharding`` of a model split over
        parts (``loss_fn`` and ``embed_fn`` then run collectives, which
        every part calls).
      The others as ``BaseEmbedding``'s.
    """

    def __init__(self, base_path, origin_folder, embedding_folder, node_list,
                 model, loss_fn, embed_fn, data, device,
                 model_folder="model", file_sep="\t", state_init=None,
                 embed_state_fn=None, sharding=None):
        super().__init__(base_path, origin_folder, embedding_folder,
                         node_list, model, embed_fn, data, device,
                         model_folder=model_folder, file_sep=file_sep)
        self.loss_fn = loss_fn
        self.state_init = state_init
        self.embed_state_fn = embed_state_fn
        self.sharding = sharding

    def learn_embedding(self, epoch=50, batch_size=1024, lr=1e-3,
                        start_idx=0, weight_decay=0.0, model_file="ctgcn",
                        load_model=False, shuffle=True, export=True, seed=0,
                        verbose=True, profile_dir=None, phase_times=False):
        """Train, export, save (rank 0 writes).  ``profile_dir``: trace
        the steady-state epochs there (``profiling.EpochTracer``);
        ``phase_times``: print ``[phase]`` lines for the embedding
        forward, its export and the model save.  Returns a dict:
        ``cost_time`` (seconds of training), per epoch ``losses`` and
        ``epoch_seconds``, and ``export_seconds`` (embedding export and
        model save)."""
        model = self.model
        sharding = self.sharding
        model_path = os.path.join(self.model_base_path, model_file or "")
        if load_model and model_file and os.path.exists(model_path):
            load_model_file(model, model_path, self.device, sharding)
        # the training time includes the optimizer's construction (the
        # first one in a process imports much of torch lazily)
        st = time.time()
        params = [p for p in model.parameters() if p.requires_grad]
        optimizer = make_optimizer(params, lr, weight_decay)
        perm_rng = np.random.default_rng(seed)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        losses, epoch_seconds = [], []
        tracer = EpochTracer(profile_dir, epoch, self.device)
        with traced_if_profiled(self.device):
            for e in range(epoch):
                t_e = time.time()
                tracer.before_epoch(e)
                with span("epoch"):
                    loss_val = self._epoch(model, optimizer, batch_size,
                                           perm_rng, shuffle, gen)
                count("engine.epochs")
                tracer.after_epoch(e)
                epoch_seconds.append(time.time() - t_e)
                losses.append(loss_val)
                if verbose and is_primary():
                    print(f"epoch {e + 1}, loss: {loss_val:.6f}, "
                          f"cost time: {time.time() - st:.3f}s", flush=True)
            tracer.close()
        cost_time = time.time() - st
        t_export = time.time()
        clock = PhaseClock(phase_times, self.device)
        if export:
            batch_num = -(-self.node_num // batch_size)
            with torch.no_grad():
                if self.embed_state_fn is not None and batch_num > 1:
                    state = None
                    for _ in range(batch_num):
                        output, state = self.embed_state_fn(model, self.data,
                                                            state)
                else:
                    output = self.embed_fn(model, self.data)
            clock.lap("embed_fn")
            if is_primary():
                self.save_embedding(output, start_idx)
            clock.lap("save_embedding")
        if model_file:
            save_model_file(model, model_path, sharding)
            clock.lap("save_params")
        self.model = model
        return {"cost_time": cost_time, "losses": losses,
                "epoch_seconds": epoch_seconds,
                "export_seconds": time.time() - t_export}

    def _epoch(self, model, optimizer, batch_size, perm_rng, shuffle, gen):
        """One epoch: every node batch's forward, loss and backward, one
        optimizer step; returns the summed loss, read back."""
        with span("batch_plan"):
            batches, masks = batch_matrix(self.node_num, batch_size,
                                          rng=perm_rng, shuffle=shuffle)
        with span("optimizer"):
            optimizer.zero_grad(set_to_none=False)
        total = torch.zeros((), device=self.device)
        state = (None if self.state_init is None
                 else self.state_init(model, self.data))
        for b_idx, b_mask in zip(batches, masks):
            with span("batch_inputs"):
                args = (model, self.data,
                        torch.from_numpy(b_idx).to(self.device),
                        torch.from_numpy(b_mask).to(self.device), gen)
            if self.state_init is None:
                loss = self.loss_fn(*args)
            else:
                loss, state = self.loss_fn(*args, state)
                state = state.detach()
            loss.backward()
            total += loss.detach()
        if self.sharding is not None:
            self.sharding.reduce_grads(model)
        with span("optimizer"):
            optimizer.step()
        with span("readback"):
            loss_val = float(total)     # waits for the epoch to finish
            self._sync()
        return loss_val


class SupervisedEmbedding(BaseEmbedding):
    """S-node / S-edge / S-link trainer with embedding CSV export.

    Args:
      classifier: the head (``nn.Module`` on ``device``), or ``None`` for
        the link types, which score edges by the inner product.
      forward_fn: (model, classifier, data, items, generator) -> (logits,
        aux), the items of one split as ``splits`` gives them; the train
        step passes the engine's generator, the validation, test and export
        forwards ``None``.  With ``state_init``, (..., generator, state) ->
        (logits, aux, new state, embeddings).
      loss_fn: (logits, labels, mask, aux) -> (loss, accuracy) tensors.
      auc_fn: (logits, labels, mask) -> float, on the host.
      splits: {"train" | "val" | "test": (items, labels, mask)} on
        ``device`` (``training.splits``).
      state_init: optional (model, data) -> the state of an epoch's train
        step (VGRNN's hidden state).  The train step's new state feeds the
        validation forward, whose new state is kept with the best
        parameters; the test forward starts from it (from a fresh state
        when no validation epoch ran) and its embeddings are the ones
        exported.
      sharding: optional ``parallel.mesh.Sharding`` of a model split over
        parts, as ``UnsupervisedEmbedding``'s; the classifier is
        replicated.
      The others as ``BaseEmbedding``'s.
    """

    def __init__(self, base_path, origin_folder, embedding_folder, node_list,
                 model, classifier, forward_fn, loss_fn, embed_fn, auc_fn,
                 data, splits, device, model_folder="model", file_sep="\t",
                 state_init=None, sharding=None):
        super().__init__(base_path, origin_folder, embedding_folder,
                         node_list, model, embed_fn, data, device,
                         model_folder=model_folder, file_sep=file_sep)
        self.classifier = classifier
        self.forward_fn = forward_fn
        self.loss_fn = loss_fn
        self.auc_fn = auc_fn
        self.splits = splits
        self.state_init = state_init
        self.sharding = sharding

    def _modules(self):
        return [m for m in (self.model, self.classifier) if m is not None]

    def _params(self):
        """Copies of the parameters (the live tensors change in place with
        every optimizer step)."""
        return [copy.deepcopy(m.state_dict()) for m in self._modules()]

    def _run(self, split, generator=None, state=None):
        """(loss, accuracy, logits) of one split's forward; with
        ``state_init`` also (new state, embeddings)."""
        items, labels, mask = self.splits[split]
        args = (self.model, self.classifier, self.data, items, generator)
        if self.state_init is None:
            preds, aux = self.forward_fn(*args)
            extra = ()
        else:
            preds, aux, state, embs = self.forward_fn(*args, state)
            extra = (state, embs)
        loss, acc = self.loss_fn(preds, labels, mask, aux)
        return (loss, acc, preds) + extra

    def learn_embedding(self, epoch=50, lr=1e-3, start_idx=0,
                        weight_decay=0.0, model_file="ctgcn",
                        classifier_file="ctgcn_cls", load_model=False,
                        export=True, seed=0, verbose=True, profile_dir=None,
                        phase_times=False):
        """Train, keep the best-on-validation parameters (the parameters
        before training when no validation epoch runs), save them, test
        them and export their embeddings.  The train step's forward draws
        from a generator seeded ``seed``.  ``profile_dir`` and
        ``phase_times`` as ``UnsupervisedEmbedding.learn_embedding``'s.
        Returns a dict: ``cost_time``
        (seconds of training and test), per epoch ``losses`` (train),
        ``epoch_seconds`` (the train step and, from the second epoch, the
        validation forward) and ``acc_val`` (from the second epoch),
        ``best_acc_val``, ``acc_test``, ``auc_test``, ``loss_test`` and
        ``export_seconds`` (embedding export)."""
        model, cls = self.model, self.classifier
        sharding = self.sharding
        stateful = self.state_init is not None
        verbose = verbose and is_primary()
        model_path = os.path.join(self.model_base_path, model_file or "")
        cls_path = os.path.join(self.model_base_path, classifier_file or "")
        if load_model and model_file and os.path.exists(model_path):
            load_model_file(model, model_path, self.device, sharding)
            if (cls is not None and classifier_file
                    and os.path.exists(cls_path)):
                load_model_file(cls, cls_path, self.device)
        st = time.time()
        params = [p for m in self._modules() for p in m.parameters()
                  if p.requires_grad]
        optimizer = make_optimizer(params, lr, weight_decay)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        best_acc, best, best_state = -1.0, self._params(), None
        losses, acc_vals, epoch_seconds = [], [], []
        tracer = EpochTracer(profile_dir, epoch, self.device)
        with traced_if_profiled(self.device):
            for e in range(epoch):
                t_e = time.time()
                tracer.before_epoch(e)
                with span("epoch"):
                    optimizer.zero_grad(set_to_none=False)
                    state = (self.state_init(model, self.data) if stateful
                             else None)
                    loss, acc, _, *rest = self._run("train", gen, state)
                    loss.backward()
                    if sharding is not None:
                        sharding.reduce_grads(model, *self._modules()[1:])
                    optimizer.step()
                    losses.append(float(loss.detach()))
                count("engine.epochs")
                tracer.after_epoch(e)
                if e == 0:
                    self._sync()
                    epoch_seconds.append(time.time() - t_e)
                    if verbose:
                        print(f"Epoch: 1 loss_train: {losses[-1]:.4f}",
                              flush=True)
                    continue
                with torch.no_grad():
                    state = rest[0].detach() if stateful else None
                    loss_v, acc_v, preds_v, *rest_v = self._run("val", None,
                                                                state)
                acc_vals.append(float(acc_v))
                better = acc_vals[-1] > best_acc
                if sharding is not None:
                    better = part0_flag(better, sharding.parts, self.device)
                if better:
                    best_acc, best = acc_vals[-1], self._params()
                    best_state = rest_v[0] if stateful else None
                if verbose:
                    _, labels_v, mask_v = self.splits["val"]
                    print(f"Epoch: {e + 1} loss_train: {losses[-1]:.4f} "
                          f"acc_train: {float(acc):.4f} "
                          f"loss_val: {float(loss_v):.4f} "
                          f"acc_val: {acc_vals[-1]:.4f} auc_val: "
                          f"{self.auc_fn(preds_v, labels_v, mask_v):.4f}",
                          flush=True)
                self._sync()
                epoch_seconds.append(time.time() - t_e)
            tracer.close()
        for m, params in zip(self._modules(), best):
            m.load_state_dict(params)
        clock = PhaseClock(phase_times, self.device)
        if model_file:
            save_model_file(model, model_path, sharding)
        if classifier_file and cls is not None:
            save_model_file(cls, cls_path)
        clock.lap("save_params")
        with torch.no_grad():
            if stateful and best_state is None:
                best_state = self.state_init(model, self.data)
            loss_te, acc_te, preds_te, *rest_te = self._run("test", None,
                                                            best_state)
        _, labels_te, mask_te = self.splits["test"]
        auc_te = self.auc_fn(preds_te, labels_te, mask_te)
        if is_primary():
            print(f"Test set results: loss= {float(loss_te):.4f} "
                  f"accuracy= {float(acc_te):.4f} auc= {auc_te:.4f}",
                  flush=True)
        clock.lap("test")
        cost_time = time.time() - st
        t_export = time.time()
        if export:
            if stateful:
                output = rest_te[1]
            else:
                with torch.no_grad():
                    output = self.embed_fn(model, self.data)
            clock.lap("embed_fn")
            if is_primary():
                self.save_embedding(output, start_idx)
            clock.lap("save_embedding")
        return {"cost_time": cost_time, "losses": losses,
                "epoch_seconds": epoch_seconds, "acc_val": acc_vals,
                "best_acc_val": best_acc, "acc_test": float(acc_te),
                "auc_test": auc_te, "loss_test": float(loss_te),
                "export_seconds": time.time() - t_export}
