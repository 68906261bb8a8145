# coding: utf-8
"""DynGEM, DynAE, DynRNN and DynAERNN: the dense autoencoder baselines
(port of ``ctgcn_tpu/nn/dynae.py``), their losses, trainer and driver.

Each window is one dense [W, N, N] adjacency tensor on the device, built
there from each snapshot's scipy matrix, one snapshot at a time.  A
training row is one directed edge of the window's single snapshot
(DynGEM: the rows of both endpoints are reconstructed) or one (step,
node) pair (the others: the node's rows in the ``look_back`` snapshots
before predict its row in the next).

Traps kept from the JAX package (``ROADMAP.md``'s parity traps):

  * ``ReluMLP`` applies ReLU after every layer, the last included, so the
    embeddings are non-negative.
  * Every batch is a fresh uniform sample of ``batch_size`` rows without
    replacement, drawn independently of the epoch's other batches: an
    epoch need not see every row and may see one row twice.
  * The gradients of an epoch's batches are summed before its one Adam
    step, and each batch adds the regularization term, so over an epoch
    it weighs ``batch_num`` times.
  * With ``bias: false`` the LSTM cells keep zero biases as trainable
    parameters, as the JAX cells do.
  * With ``load_model`` a window starts from whatever file sits at
    ``<base>/<model_folder>/<model_file>``, stale ones included; Adam's
    state starts fresh each window.

GEMMs run in full FP32: the driver turns TF32 off for the run.
"""
from __future__ import annotations

import functools
import os
import time

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn
from torch.nn import functional as F

from ctgcn_torch.data.formats import read_node_list, write_time_csv
from ctgcn_torch.data.loader import DataLoader
from ctgcn_torch.nn.layers import Linear
from ctgcn_torch.ops.rnn import LSTMCell, rnn_scan
from ctgcn_torch.training.engine import (BaseEmbedding, load_model_file,
                                         make_optimizer, save_model_file)
from ctgcn_torch.utils import resolve_device

DYN_METHODS = ("DynGEM", "DynAE", "DynRNN", "DynAERNN")


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

class ReluMLP(nn.Module):
    """MLP with ReLU after every layer, the last included."""

    def __init__(self, input_dim, output_dim, n_units, bias=True,
                 generator=None):
        super().__init__()
        dims = [input_dim] + list(n_units) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], bias, generator=generator)
            for i in range(len(dims) - 1))

    def forward(self, x):
        for lin in self.layers:
            x = F.relu(lin(x))
        return x


class MLLSTM(nn.Module):
    """Stacked LSTMs over the whole sequence."""

    def __init__(self, input_dim, output_dim, n_units, bias=True,
                 generator=None):
        super().__init__()
        dims = [input_dim] + list(n_units) + [output_dim]
        self.cells = nn.ModuleList(
            LSTMCell(dims[i], dims[i + 1], bias, generator=generator)
            for i in range(len(dims) - 1))

    def forward(self, x):
        """x: [B, T, in] -> (outputs [B, T, out], last step [B, out])."""
        h = x.transpose(0, 1)
        for cell in self.cells:
            h, _ = rnn_scan(cell, h)
        out = h.transpose(0, 1)
        return out, out[:, -1, :]


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

class DynGEM(nn.Module):
    def __init__(self, input_dim, output_dim, n_units=(500, 300), bias=True,
                 generator=None):
        super().__init__()
        self.encoder = ReluMLP(input_dim, output_dim, n_units, bias,
                               generator)
        self.decoder = ReluMLP(output_dim, input_dim, tuple(n_units)[::-1],
                               bias, generator)

    def forward(self, x):
        """x: [B, N] -> (embedding [B, d], reconstruction [B, N])."""
        hx = self.encoder(x)
        return hx, self.decoder(hx)


class DynAE(nn.Module):
    def __init__(self, input_dim, output_dim, look_back=3,
                 n_units=(500, 300), bias=True, generator=None):
        super().__init__()
        self.look_back = look_back
        self.encoder = ReluMLP(input_dim * look_back, output_dim, n_units,
                               bias, generator)
        self.decoder = ReluMLP(output_dim, input_dim, tuple(n_units)[::-1],
                               bias, generator)

    def forward(self, x):
        """x: [B, look_back * N], step-major -> (embedding [B, d],
        prediction [B, N])."""
        hx = self.encoder(x)
        return hx, self.decoder(hx)


class DynRNN(nn.Module):
    def __init__(self, input_dim, output_dim, look_back=3,
                 n_units=(500, 300), bias=True, generator=None):
        super().__init__()
        self.look_back = look_back
        self.encoder = MLLSTM(input_dim, output_dim, n_units, bias,
                              generator)
        self.decoder = MLLSTM(output_dim, input_dim, tuple(n_units)[::-1],
                              bias, generator)

    def forward(self, x):
        """x: [B, look_back, N]; the decoder reads the encoder's whole
        sequence and its last step is the prediction."""
        output, hx = self.encoder(x)
        _, x_pred = self.decoder(output)
        return hx, x_pred


class DynAERNN(nn.Module):
    def __init__(self, input_dim, output_dim, look_back=3,
                 ae_units=(500, 300), rnn_units=(500,), bias=True,
                 generator=None):
        super().__init__()
        self.look_back = look_back
        self.ae_encoders = nn.ModuleList(
            ReluMLP(input_dim, output_dim, ae_units, bias, generator)
            for _ in range(look_back))
        self.rnn_encoder = MLLSTM(output_dim, output_dim, rnn_units, bias,
                                  generator)
        self.decoder = ReluMLP(output_dim, input_dim, tuple(ae_units)[::-1],
                               bias, generator)

    def forward(self, x):
        """x: [B, look_back, N]: one ``ReluMLP`` a step, an ``MLLSTM``
        over their outputs, a ``ReluMLP`` decoder of its last step."""
        ae_hx = torch.stack([mlp(x[:, t, :])
                             for t, mlp in enumerate(self.ae_encoders)], 1)
        _, hx = self.rnn_encoder(ae_hx)
        return hx, self.decoder(hx)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def regularization_loss(model, nu1, nu2):
    """nu1 times the mean L1 norm and nu2 times the mean Frobenius norm
    (not its square) of the model's 2-D parameters: the ``Linear`` weights
    and the LSTM ``w_ih``/``w_hh``, not the biases."""
    if nu1 == 0.0 and nu2 == 0.0:
        return 0.0
    weights = [p for p in model.parameters() if p.ndim == 2]
    n = max(len(weights), 1)
    l1 = sum(w.abs().sum() for w in weights) if nu1 > 0 else 0.0
    l2 = sum(w.square().sum().sqrt() for w in weights) if nu2 > 0 else 0.0
    return nu1 * l1 / n + nu2 * l2 / n


def dyngraph2vec_loss(model, x_pred, x_real, penalty, nu1, nu2):
    recon = ((x_pred - x_real) * penalty).square().sum(1).mean()
    return recon + regularization_loss(model, nu1, nu2)


def dyngem_loss(model, xi_pred, xi, pen_i, deg_i, xj_pred, xj, pen_j, deg_j,
                hx_i, hx_j, edge_w, alpha, nu1, nu2):
    """Each endpoint's reconstruction term divided by its degree, and the
    embeddings' squared distance weighted by the edge's value."""
    xi_loss = (((xi_pred - xi) * pen_i).square().sum(1) / deg_i).mean()
    xj_loss = (((xj_pred - xj) * pen_j).square().sum(1) / deg_j).mean()
    hx_loss = ((hx_i - hx_j).square().sum(1) * edge_w).mean()
    return (xi_loss + xj_loss + alpha * hx_loss
            + regularization_loss(model, nu1, nu2))


def _penalty(x, beta):
    return torch.where(x != 0, beta, 1.0)


def make_batch_loss(method, look_back, alpha, beta, nu1, nu2):
    """(model, data, b_idx) -> one batch's loss.  ``data``: DynGEM's
    (graph [N, N], rows, cols, values) of its snapshot's edges; the
    others' (window [W, N, N],), whose row ``g * N + node`` predicts
    ``window[g + look_back, node]`` from ``window[g:g + look_back,
    node]``."""
    if method == "DynGEM":
        def batch_loss(model, data, b_idx):
            graph, rows, cols, values = data
            xi, xj = graph[rows[b_idx]], graph[cols[b_idx]]
            hx_i, xi_pred = model(xi)
            hx_j, xj_pred = model(xj)
            return dyngem_loss(model, xi_pred, xi, _penalty(xi, beta),
                               xi.sum(1), xj_pred, xj, _penalty(xj, beta),
                               xj.sum(1), hx_i, hx_j, values[b_idx], alpha,
                               nu1, nu2)
        return batch_loss

    def batch_loss(model, data, b_idx):
        (window,) = data
        n = window.shape[1]
        g, node = b_idx // n, b_idx % n
        steps = torch.arange(look_back, device=b_idx.device)
        x_pre = window[g[:, None] + steps, node[:, None]]   # [B, lb, N]
        x_cur = window[g + look_back, node]
        if method == "DynAE":
            x_pre = x_pre.reshape(x_pre.shape[0], -1)
        _, x_pred = model(x_pre)
        return dyngraph2vec_loss(model, x_pred, x_cur,
                                 _penalty(x_cur, beta), nu1, nu2)
    return batch_loss


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def draw_batches(rows, batch_size, batch_num, generator):
    """``batch_num`` index batches, each an independent uniform sample of
    ``batch_size`` of the ``rows`` row ids without replacement (CPU
    tensors; ``generator`` is a CPU ``torch.Generator``)."""
    return [torch.randperm(rows, generator=generator)[:batch_size]
            for _ in range(batch_num)]


def train_epoch(model, optimizer, batch_loss, data, batches):
    """One epoch: the gradients of every batch of ``batches`` summed, then
    one optimizer step.  Returns the summed loss, a tensor on the
    device."""
    optimizer.zero_grad(set_to_none=False)
    total = 0.0
    for b_idx in batches:
        loss = batch_loss(model, data, b_idx)
        loss.backward()
        total = total + loss.detach()
    optimizer.step()
    return total


def embed(method, look_back, model, data):
    """Every node's embedding [N, d] (``data`` as ``make_batch_loss``
    takes it): DynGEM's from the window's snapshot, the others' from its
    last ``look_back`` snapshots."""
    if method == "DynGEM":
        return model(data[0])[0]
    window = data[0]
    x_pre = window[window.shape[0] - look_back:].transpose(0, 1)
    if method == "DynAE":
        x_pre = x_pre.reshape(x_pre.shape[0], -1)
    return model(x_pre)[0]


class DynamicEmbedding(BaseEmbedding):
    """The trainer of the four models over one dense window.

    Args:
      window: [W, N, N] float32 on ``device``.
      edge_data: DynGEM's (rows, cols, values) of ``window[0]``'s
        nonzeros, host arrays.
      The others as ``BaseEmbedding``'s.
    """

    def __init__(self, base_path, origin_folder, embedding_folder, node_list,
                 model, method, look_back, window, device, edge_data=None,
                 model_folder="model", file_sep="\t"):
        if method == "DynGEM":
            rows, cols, values = edge_data
            data = (window[0], torch.as_tensor(rows, device=device).long(),
                    torch.as_tensor(cols, device=device).long(),
                    torch.as_tensor(values, dtype=torch.float32,
                                    device=device))
            self.row_num = len(rows)
        else:
            if window.shape[0] <= look_back:
                raise ValueError(f"a window of {window.shape[0]} snapshots "
                                 f"leaves none after look_back {look_back}")
            data = (window,)
            self.row_num = len(node_list) * (window.shape[0] - look_back)
        super().__init__(base_path, origin_folder, embedding_folder,
                         node_list, model,
                         functools.partial(embed, method, look_back), data,
                         device, model_folder=model_folder,
                         file_sep=file_sep)
        self.method = method
        self.look_back = look_back

    def learn_embedding(self, beta, nu1, nu2, alpha=0.0, epoch=50,
                        batch_size=1024, lr=1e-3, idx=0, weight_decay=0.0,
                        model_file="dynae", load_model=False, export=True,
                        seed=0, verbose=True):
        """Train ``epoch`` epochs, export the embedding of every node as
        snapshot ``idx``'s CSV, save the parameters.  Each epoch draws its
        batches from a CPU generator seeded ``seed`` (``draw_batches``)
        and runs ``train_epoch`` over them.  Returns a dict:
        ``cost_time`` (seconds of training), per epoch ``losses`` (each the
        sum of the epoch's batch losses) and ``epoch_seconds``,
        ``export_seconds`` (the export and the save) and ``batch_num``."""
        model = self.model
        model_path = os.path.join(self.model_base_path, model_file or "")
        if load_model and model_file and os.path.exists(model_path):
            load_model_file(model, model_path, self.device)
        st = time.time()
        optimizer = make_optimizer(list(model.parameters()), lr,
                                   weight_decay)
        batch_size = min(batch_size, self.row_num)
        batch_num = -(-self.row_num // batch_size)
        batch_loss = make_batch_loss(self.method, self.look_back, alpha,
                                     beta, nu1, nu2)
        gen = torch.Generator().manual_seed(seed)
        losses, epoch_seconds = [], []
        for e in range(epoch):
            t_e = time.time()
            batches = draw_batches(self.row_num, batch_size, batch_num, gen)
            total = train_epoch(model, optimizer, batch_loss, self.data,
                                [b.to(self.device) for b in batches])
            losses.append(float(total))     # waits for the epoch to finish
            epoch_seconds.append(time.time() - t_e)
            if verbose:
                print(f"epoch {e + 1}, loss: {losses[-1]:.6f}, "
                      f"cost time: {time.time() - st:.3f}s", flush=True)
        cost_time = time.time() - st
        t_export = time.time()
        if export:
            with torch.no_grad():
                self.save_embedding(self.embed_fn(model, self.data), idx)
        if model_file:
            save_model_file(model, model_path)
        return {"cost_time": cost_time, "losses": losses,
                "epoch_seconds": epoch_seconds,
                "export_seconds": time.time() - t_export,
                "batch_num": batch_num}


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def dense_window(mats, device):
    """[W, N, N] float32 on ``device`` equal to ``stack([m.toarray() for m
    in mats])`` cast to float32, filled from each matrix's entries (its
    duplicates summed in float64 first, as ``toarray`` sums them)."""
    n = mats[0].shape[0]
    out = torch.zeros(len(mats), n, n, device=device)
    for t, m in enumerate(mats):
        c = m.tocsr().tocoo()
        rows = torch.from_numpy(c.row.astype(np.int64)).to(device)
        cols = torch.from_numpy(c.col.astype(np.int64)).to(device)
        out[t, rows, cols] = torch.from_numpy(
            c.data.astype(np.float32)).to(device)
    return out


def build_model(method, node_num, args, generator):
    """A fresh model of ``method`` at the config's widths, its parameters
    drawn from ``generator``."""
    embed_dim = args["embed_dim"]
    bias = args.get("bias", True)
    look_back = args.get("look_back", 0)
    n_units = tuple(args.get("n_units", (500, 300)))
    kw = dict(bias=bias, generator=generator)
    if method == "DynGEM":
        return DynGEM(node_num, embed_dim, n_units, **kw)
    if method == "DynAE":
        return DynAE(node_num, embed_dim, look_back, n_units, **kw)
    if method == "DynRNN":
        return DynRNN(node_num, embed_dim, look_back, n_units, **kw)
    return DynAERNN(node_num, embed_dim, look_back,
                    tuple(args.get("ae_units", (500, 300))),
                    tuple(args.get("rnn_units", (500,))), **kw)


def dyngem_embedding(method, args, device="cuda"):
    """Run DynGEM, DynAE, DynRNN or DynAERNN over every window of the
    config: window ``[idx - duration + 1, idx]`` for each ``idx`` from
    ``start_idx`` to ``end_idx`` (negative ones count from the end), one
    embedding CSV for ``idx``.

    Returns one dict per window: ``idx``, ``time_length`` (1: the CSVs it
    writes), ``setup_seconds`` (the window's matrices, its dense copy on
    the device and the model), ``core_backend`` ("dense") and what
    ``DynamicEmbedding.learn_embedding`` returns.  The GEMMs run in full
    FP32: TF32 is turned off for the run and the caller's setting restored
    after it."""
    if method not in DYN_METHODS:
        raise ValueError(f"method {method!r}, not one of {DYN_METHODS}")
    dev = resolve_device(device)
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _run_windows(method, args, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32


def get_data_loader(args):
    """(DataLoader over the config's node list and snapshots, the
    snapshots' absolute folder)."""
    base_path = args["base_path"]
    origin_base_path = os.path.abspath(
        os.path.join(base_path, args["origin_folder"]))
    node_list = read_node_list(
        os.path.abspath(os.path.join(base_path, args["node_file"])))
    return (DataLoader(node_list, len(os.listdir(origin_base_path))),
            origin_base_path)


def build_trainer(method, args, data_loader, origin_base_path, idx, device,
                  generator):
    """The trainer of the window ending at snapshot ``idx``: its matrices,
    their dense copy on ``device``, DynGEM's edges and a fresh model drawn
    from ``generator``."""
    mats = data_loader.get_scipy_adj_list(
        origin_base_path, idx - args["duration"] + 1, args["duration"],
        sep=args.get("file_sep", "\t"))
    model = build_model(method, data_loader.node_num, args, generator)
    return DynamicEmbedding(
        base_path=args["base_path"], origin_folder=args["origin_folder"],
        embedding_folder=args["embed_folder"],
        node_list=data_loader.full_node_list, model=model.to(device),
        method=method, look_back=args.get("look_back", 0),
        window=dense_window(mats, device), device=device,
        edge_data=sp.find(mats[0]) if method == "DynGEM" else None,
        model_folder=args.get("model_folder", "model"),
        file_sep=args.get("file_sep", "\t"))


def train_kwargs(method, args):
    """``learn_embedding``'s arguments from the config, but ``idx`` and
    ``seed``."""
    return dict(beta=args["beta"], nu1=args["nu1"], nu2=args["nu2"],
                alpha=args.get("alpha", 0.0), epoch=args["epoch"],
                batch_size=args["batch_size"], lr=args["lr"],
                weight_decay=args.get("weight_decay", 0.0),
                model_file=args.get("model_file", method.lower()),
                load_model=args.get("load_model", False),
                export=args.get("export", True))


def _run_windows(method, args, dev):
    start_idx = args["start_idx"]
    end_idx = args["end_idx"]
    duration = args["duration"]
    look_back = args.get("look_back", 0)
    data_loader, origin_base_path = get_data_loader(args)
    max_time_num = data_loader.max_time_num
    if start_idx < 0:
        start_idx = max_time_num + start_idx
    end_idx = max_time_num + end_idx + 1 if end_idx < 0 else end_idx + 1
    if method == "DynGEM" and duration != 1:
        raise ValueError(f"DynGEM embeds one snapshot (duration 1, not "
                         f"{duration})")
    if start_idx + 1 - duration < 0:
        raise ValueError(f"window {start_idx} of duration {duration} starts "
                         "before the first snapshot")
    if duration <= look_back:
        raise ValueError(f"duration {duration} must exceed look_back "
                         f"{look_back}")

    t_start = time.time()
    gen = torch.Generator().manual_seed(args.get("seed", 0))
    time_list, results = [], []
    print(f"start {method} embedding! (ctgcn_torch on {dev})")
    for widx, idx in enumerate(range(start_idx, end_idx)):
        print("idx =", idx)
        t_setup = time.time()
        trainer = build_trainer(method, args, data_loader, origin_base_path,
                                idx, dev, gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_seconds = time.time() - t_setup
        res = trainer.learn_embedding(idx=idx, seed=widx,
                                      **train_kwargs(method, args))
        time_list.append(res["cost_time"])
        results.append({"idx": idx, "time_length": 1,
                        "setup_seconds": setup_seconds,
                        "core_backend": "dense", **res})
        if args.get("record_time", False):
            write_time_csv(os.path.join(args["base_path"],
                                        method + "_time.csv"), time_list)
    print(f"finish {method} embedding! cost time: "
          f"{time.time() - t_start} seconds!")
    return results
