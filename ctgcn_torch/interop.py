# coding: utf-8
"""Parameters of the JAX package's models as the port's state_dicts.

``params_from_numpy(tree)`` takes the parameter tree of a JAX ``CTGCN`` or
``CGCN`` (either variant) as nested dicts of numpy arrays -- what
``flax.serialization.to_state_dict`` gives, converted leaf by leaf with
``numpy.asarray`` -- and returns the ``state_dict`` of the port's model of
the same name in ``ctgcn_torch.nn.core_models``.  CTGCN's per-timestep
``mlps``/``cdns`` leaves carry a leading [T] axis there and become one
module per timestep here; CGCN's shared ``mlp``/``cdn`` map as they are.
Layouts match without transposes: ``Linear.weight`` is [in, out] in both
packages and the RNN cells use torch's gate layout in both.  The trees of
the JAX heads ``MLPClassifier`` and ``EdgeClassifier`` map as they are onto
``ctgcn_torch.nn.heads``'s (``mlp.layers.<i>.*``,
``classifier.mlp.layers.<i>.*``), and so do the zoo's ``GCN``
(``gc1.*``, ``gc2.*``) and ``GIN`` (``linear.*``,
``mlps.<l>.layers.<i>.*``, ``mlps.<l>.norms.<i>.*``, ``norms.<l>.*``,
``eps``) onto ``ctgcn_torch.nn.gcn`` and ``ctgcn_torch.nn.gin``: GIN's
``mlps`` is a tuple of layers, not a leaf with a [T] axis.  The zoo's
``GAT`` (``attentions.<i>.W``, ``attentions.<i>.a``, ``out_att.W``,
``out_att.a``) and ``SAGE`` (``linear.*``, ``sage1.linear.*``,
``sage2.linear.*``) map as they are onto ``ctgcn_torch.nn.gat`` and
``ctgcn_torch.nn.sage``.  ``GCRN``'s ``gcns`` leaves carry a leading [T]
axis, as CTGCN's ``mlps`` do, and become ``gcns.<t>.gc1.*`` /
``gcns.<t>.gc2.*``; its ``rnn`` and ``norm`` map as CTGCN's.
``EvolveGCN`` (``grcu<l>.evolve_weights.{update,reset,htilda}.{W,U,bias}``,
``grcu<l>.evolve_weights.choose_topk.scorer``,
``grcu<l>.GCN_init_weights``) maps as it is onto ``ctgcn_torch.nn.egcn``,
and ``VGRNN`` (``phi_x``, ``phi_z``, ``prior``, ``prior_mean``,
``prior_std``: ``Linear``; ``enc``, ``enc_mean``, ``enc_std``:
``GraphConv``; ``rnn.{xz,hz,xr,hr,xh,hh}.<layer>``) onto
``ctgcn_torch.nn.vgrnn``, and ``PGNN`` (``linear_pre``, ``conv_first``,
``conv_hidden.<i>`` and ``conv_out``, each layer with
``dist_compute.linear{1,2}``, ``linear_hidden`` and
``linear_out_position``; ``linear_pre`` and ``conv_out`` are absent
without ``feature_pre`` and at one layer) onto ``ctgcn_torch.nn.pgnn``.
The non-GNN baselines' trees map as they are onto
``ctgcn_torch.nn.dynae``: ``encoder.layers.<i>.{weight,bias}`` and
``decoder.layers.<i>.*`` (DynGEM, DynAE; DynAERNN's decoder),
``encoder.cells.<i>.{w_ih,w_hh,b_ih,b_hh}`` and ``decoder.cells.<i>.*``
(DynRNN), ``ae_encoders.<t>.layers.<i>.*`` and
``rnn_encoder.cells.<i>.*`` (DynAERNN).

``params_to_numpy(state_dict, family)`` is the inverse: the port's
``state_dict`` of the model class named ``family`` as the tree
``to_state_dict`` gives for the JAX model of that name, which
``training.model_file.write_flax_msgpack`` writes as the JAX package's
``save_params`` does.  It restacks the per-timestep modules onto the
leading [T] axis and writes ``None`` (or an empty map, an empty tuple of
layers) for each field the JAX model holds empty where the port has no
module: a layer's ``bias`` without bias, PGNN's ``linear_pre`` without
``feature_pre``, its ``conv_hidden`` below three layers and its
``conv_out`` at one, GIN's inner ``norms`` at one MLP layer.
"""
from __future__ import annotations

import copy

import numpy as np
import torch


#: the containers of one module a timestep in the port whose JAX leaves
#: carry a leading [T] axis (the models' ``TimeRule.stacked``)
_STACKED = {"CTGCN": ("mlps", "cdns"), "GCRN": ("gcns",)}
#: family -> (path, value) of each field the JAX model holds as ``None`` or
#: an empty tuple where the port's model has no module ("*": every key)
_ABSENT = {"PGNN": (("linear_pre", None), ("conv_hidden", {}),
                    ("conv_out", None)),
           "GIN": (("mlps.*.norms", {}),)}


def _flatten(tree, prefix=""):
    """{'a': {'0': {'b': x}}} -> {'a.0.b': x}, ``None`` leaves dropped."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        elif val is not None:
            out[name] = np.asarray(val)
    return out


def params_from_numpy(tree):
    """JAX CTGCN / CGCN / MLPClassifier / EdgeClassifier / GCN / GIN / GAT
    / SAGE / GCRN / EvolveGCN / VGRNN / PGNN / DynGEM / DynAE / DynRNN /
    DynAERNN parameter tree (nested dicts of arrays) -> state_dict."""
    state = {}
    for name, arr in _flatten(tree).items():
        head, _, rest = name.partition(".")
        if (head in ("mlps", "cdns", "gcns")
                and not rest.split(".")[0].isdigit()):
            for t in range(arr.shape[0]):
                state[f"{head}.{t}.{rest}"] = torch.tensor(
                    arr[t], dtype=torch.float32)
        else:
            state[name] = torch.tensor(arr, dtype=torch.float32)
    return state


def _nest(tree, parts, value):
    for key in parts[:-1]:
        tree = tree.setdefault(key, {})
    tree[parts[-1]] = value


def _absent(tree, parts, value):
    """``value`` at every path that ``parts`` matches and lacks."""
    if not isinstance(tree, dict):
        return
    head, rest = parts[0], parts[1:]
    if not rest:
        tree.setdefault(head, copy.deepcopy(value))
    elif head == "*":
        for sub in tree.values():
            _absent(sub, rest, value)
    elif head in tree:
        _absent(tree[head], rest, value)


def _no_bias(tree):
    """A ``bias: None`` beside each ``weight`` leaf without one: every JAX
    layer with a ``weight`` (``Linear``, ``GraphConvolution``,
    ``GraphConv``) holds its bias as ``None`` when it has none."""
    for val in tree.values():
        if isinstance(val, dict):
            _no_bias(val)
    if isinstance(tree.get("weight"), np.ndarray):
        tree.setdefault("bias", None)


def _host(tensor):
    return tensor.detach().to("cpu", torch.float32).numpy()


def params_to_numpy(state_dict, family):
    """The port's ``state_dict`` of the model class named ``family`` ->
    the JAX model's ``to_state_dict`` tree: nested dicts of float32 numpy
    arrays, ``None`` and empty maps.  Per-timestep tensors are stacked
    where they lie (on the card, one copy to the host a leaf)."""
    stacked = _STACKED.get(family, ())
    tree, stacks = {}, {}
    for name, val in state_dict.items():
        parts = name.split(".")
        if parts[0] in stacked:
            stacks.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = val
        else:
            _nest(tree, parts, _host(val))
    for parts, per_t in stacks.items():
        if sorted(per_t) != list(range(len(per_t))):
            raise ValueError(f"{'.'.join(parts)}: timesteps "
                             f"{sorted(per_t)} are not 0..T-1")
        _nest(tree, parts,
              _host(torch.stack([per_t[t] for t in range(len(per_t))])))
    _no_bias(tree)
    for path, value in _ABSENT.get(family, ()):
        _absent(tree, path.split("."), value)
    return tree
