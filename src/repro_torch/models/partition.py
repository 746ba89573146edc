"""The LM zoo's blocks partitioned over a ``DeviceMesh``, for DTensors.

``models.layers``, ``models.model`` and ``models.steps`` hand a block to
this module when its activations are DTensors on a mesh whose ``model``
axis splits anything (the dry run, ``launch.dryrun``; a ``Trainer`` or
a restore on a mesh); plain tensors never reach it.  Each block runs as
a *region*: its DTensor inputs are brought to the placements below, the
plain block (``layers.attention``, ``layers.mla_attention``,
``layers.mlp``, ``layers.moe_experts``, ``model._cross_attention``...),
or its pieces (``layers.mamba_conv``, ``mamba_scan``, ``mlstm_weights``,
``slstm_cell``...), runs on the local shards of its weights, and its
output leaves as a DTensor.  This module adds only the collectives, and
local arithmetic where no plain block exists: a softmax split over
cache shards, the vocabulary-parallel lookup, loss and pick, and the
MoE's slot offset.
Inside a region every collective is explicit, so the plan is the same
on every torch version; outside one, DTensor's own sharding rules place
the norms, the residual adds and the optimizer's elementwise update.
The plan is the one the JAX package's GSPMD partitioner finds for
``param_specs`` and ``cache_plan`` (Megatron-style tensor parallelism
on ``model``, the batch on the data axes):

- activations ``(B, S, d)`` are sharded on the batch over the data axes
  (``pod``, ``data``) and replicated on ``model``;
- attention (and MLA) runs the plain block on its share of the heads on
  each ``model`` rank when the heads divide the axis: column-parallel
  projections, row-parallel output, one all-reduce; a key/value head
  that several ranks share is taken from the gathered ``wk`` / ``wv``.
  When the heads do not divide the axis, each rank takes S / m query
  rows of every head from the gathered weights, and the rows are
  gathered after the output projection; when the rows do not divide
  either, every rank runs the whole block;
- a decode step attends over the cache's sequence shard on each rank
  (the cache is sharded on its sequence axis, ``cache_plan``): the new
  token's query, key and value are gathered, the softmax's max and sum
  and the partial outputs are all-reduced;
- Mamba, the mLSTM and the sLSTM split their channels over ``model``:
  the column-parallel projection whose columns hold ``[xi | z]``,
  ``[u | z]`` or ``[i | f | z | o]`` is regrouped by one all-to-all so
  that each rank holds every piece of its channels (GSPMD's plan moves
  the same columns with collective-permutes); Mamba's scan needs no
  collective inside it, the sLSTM gathers ``h`` at every token; the
  mLSTM's heads follow the plan's split of its columns (whole heads, or
  a slice of one head's dims whose logits are summed over the ranks
  that share the head); the output projections are row-parallel, one
  all-reduce; a decode step updates this rank's shard of each state.
  A block whose channels ``model`` does not divide raises;
- the MLP is column- then row-parallel, one all-reduce; the MoE keeps
  each data shard's tokens where they are: every ``model`` rank runs
  its share of the experts on the tokens of its data shard, with the
  capacity and slot order of the whole batch (the counts per expert are
  gathered over the data axes), and the outputs are all-reduced;
- the embedding lookup, the loss (logsumexp and the picked logit) and
  decode's argmax are vocabulary-parallel: a masked local lookup and
  all-reduces of ``(B, S)`` partials, as GSPMD does;
- partial sums are all-reduced in their own dtype, as GSPMD's plan
  does (bf16 in a bf16 model);
- the gradient of a weight is a partial sum over the data axes (and
  over ``model`` for a weight the ``model`` ranks use differently);
  ``sync_grad`` reduces it once, to its parameter's placements.

What a block computes does not change, only where: the partial sums add
up to the unpartitioned result (``tests/test_torch_partition_mesh.py``
holds every region against the plain step on real meshes).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

MODEL = "model"
_REGIONS: list[str] = []


def region_name() -> str | None:
    """The innermost region running now (the dry run labels the
    collectives a region issues with it)."""
    return _REGIONS[-1] if _REGIONS else None


@contextlib.contextmanager
def _region(name: str):
    _REGIONS.append(name)
    try:
        yield
    finally:
        _REGIONS.pop()


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def applies(x) -> bool:
    """Whether ``x`` is a DTensor on a mesh whose ``model`` axis splits
    anything (on a mesh without one, DTensor's own rules run the plain
    blocks: data parallelism alone needs no region)."""
    if not isinstance(x, DTensor):
        return False
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    return MODEL in names and mesh.size(names.index(MODEL)) > 1


class Layout:
    """The mesh of activation ``x`` (one that ``applies``) and the
    placements this module gives activations: the batch (dim 0) sharded
    on the data axes where ``x`` has it so, everything else replicated."""

    def __init__(self, x: DTensor):
        self.mesh = x.device_mesh
        self.mi = self.mesh.mesh_dim_names.index(MODEL)
        self.m = self.mesh.size(self.mi)
        coord = self.mesh.get_coordinate()
        self.rank = coord[self.mi]
        self.batch_dims = [i for i, p in enumerate(x.placements)
                           if i != self.mi and p == Shard(0)]
        self.shards = math.prod(self.mesh.size(i) for i in self.batch_dims)
        self.shard = 0
        for i in self.batch_dims:
            self.shard = self.shard * self.mesh.size(i) + coord[i]

    def act(self, batch_dim: int = 0, model=None) -> tuple:
        """Placements of an activation with its batch on ``batch_dim``
        and ``model`` (default replicated) on the model axis."""
        out = [Replicate()] * self.mesh.ndim
        for i in self.batch_dims:
            out[i] = Shard(batch_dim)
        if model is not None:
            out[self.mi] = model
        return tuple(out)

    def weight(self, model=None, grad_model=None) -> tuple[tuple, tuple]:
        """(placements, gradient placements) of a weight used inside a
        region: replicated on the data axes, ``model`` on the model axis;
        its gradient a partial sum over the axes the batch is sharded on,
        ``grad_model`` (default: as the weight) on the model axis."""
        pl = [Replicate()] * self.mesh.ndim
        gp = [Replicate()] * self.mesh.ndim
        for i in self.batch_dims:
            gp[i] = Partial()
        pl[self.mi] = model or Replicate()
        gp[self.mi] = grad_model or pl[self.mi]
        return tuple(pl), tuple(gp)

    # --- entering and leaving a region --------------------------------

    def x_in(self, x: DTensor, batch_dim: int = 0, grad_model=Partial()):
        """The local shard of activation ``x`` (replicated on ``model``);
        its gradient, a partial sum over ``model`` when the ranks use
        ``x`` differently, is reduced once on the way back."""
        pl = self.act(batch_dim)
        gp = self.act(batch_dim, grad_model)
        return _EnterReduced.apply(x.redistribute(self.mesh, pl), gp)

    def w_in(self, w: DTensor, shard_dim: int | None = None,
             grad_model=Partial()):
        """The local part of weight ``w``: its shard on ``model`` along
        ``shard_dim`` when it is sharded so, else gathered whole (and
        then its gradient is ``grad_model`` on the model axis)."""
        sharded = (shard_dim is not None
                   and w.placements[self.mi] == Shard(shard_dim % w.ndim))
        if sharded:
            pl, gp = self.weight(Shard(shard_dim % w.ndim))
        else:
            pl, gp = self.weight(None, grad_model)
        return w.redistribute(self.mesh, pl).to_local(grad_placements=gp)

    def rows(self, t, batch_dim: int = 0):
        """This rank's batch rows of ``t`` (a DTensor or a plain tensor
        holding the whole batch)."""
        if t is None or is_dtensor(t):
            return t if t is None else t.redistribute(
                self.mesh, self.act(batch_dim)).to_local()
        if not self.batch_dims:
            return t
        n = t.shape[batch_dim] // self.shards
        return t.narrow(batch_dim, self.shard * n, n)

    def out(self, t: torch.Tensor, batch_dim: int = 0, model=None):
        """A region's local output as a DTensor of this layout."""
        return DTensor.from_local(t, self.mesh, self.act(batch_dim, model),
                                  run_check=False)

    # --- collectives inside a region ----------------------------------

    def reduce(self, t: torch.Tensor, op: str = "sum", batch_dim: int = 0,
               grad_model=None) -> torch.Tensor:
        """All-reduce a local partial over ``model``, in its own dtype.
        ``grad_model=Partial()`` where the ranks use the sum differently:
        its gradient is then all-reduced on the way back."""
        d = DTensor.from_local(t, self.mesh,
                               self.act(batch_dim, Partial(op)),
                               run_check=False)
        gp = None if grad_model is None else self.act(batch_dim, grad_model)
        return d.redistribute(self.mesh, self.act(batch_dim)).to_local(
            grad_placements=gp)

    def sharded(self, w: DTensor, dim: int) -> torch.Tensor:
        """This rank's shard of weight ``w``, which must be sharded on
        ``model`` along ``dim`` (a region that splits the block's
        channels cannot place a weight that is not)."""
        if w.placements[self.mi] != Shard(dim % w.ndim):
            raise ValueError(f"a weight of shape {tuple(w.shape)} is "
                             f"{w.placements[self.mi]} on {MODEL}, not "
                             f"sharded along dim {dim}")
        return self.w_in(w, dim)

    def state(self, leaf: DTensor, dim: int | None) -> torch.Tensor:
        """The local tensor of recurrent-state cache leaf ``leaf``, which
        must be sharded on ``model`` along ``dim`` (whole on ``model``
        when ``dim`` is None); a decode step updates it in place."""
        want = Replicate() if dim is None else Shard(dim % leaf.ndim)
        if leaf.placements[self.mi] != want:
            raise ValueError(f"a cache leaf of shape {tuple(leaf.shape)} is "
                             f"{leaf.placements[self.mi]} on {MODEL}, "
                             f"not {want}")
        return leaf.to_local()

    def channels(self, block: str, w: DTensor, width: int) -> None:
        """Raise unless weight ``w``'s columns are sharded on ``model``
        and ``model`` divides the ``width`` channels that each of its
        column blocks holds: a recurrent region splits its channels over
        ``model`` and cannot place ``block`` otherwise."""
        if w.placements[self.mi] != Shard(w.ndim - 1) or width % self.m:
            raise ValueError(
                f"{block}: cannot split {width} channels of a weight "
                f"{tuple(w.shape)} ({w.placements[self.mi]}) over {MODEL} "
                f"of size {self.m}")

    def gather(self, t: torch.Tensor, dim: int, batch_dim: int = 0,
               grad_model=Partial()) -> torch.Tensor:
        """All-gather local shards along ``dim`` over ``model``; the
        gradient of the whole (each rank's use of it differs) is
        reduce-scattered back."""
        d = DTensor.from_local(t, self.mesh,
                               self.act(batch_dim, Shard(dim % t.ndim)),
                               run_check=False)
        return d.redistribute(self.mesh, self.act(batch_dim)).to_local(
            grad_placements=self.act(batch_dim, grad_model))


class _EnterReduced(torch.autograd.Function):
    """A DTensor's local tensor, whose gradient (with placements ``gp``)
    is brought back to the DTensor's own placements: an all-reduce over
    ``model`` where ``gp`` is partial there (Megatron's "f")."""

    @staticmethod
    def forward(ctx, x: DTensor, gp):
        ctx.spec = x._spec
        ctx.gp = gp
        ctx.region = region_name()
        ctx.set_materialize_grads(False)
        return x._local_tensor.view_as(x._local_tensor)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return None, None
        spec = ctx.spec
        d = DTensor.from_local(g, spec.mesh, ctx.gp, run_check=False,
                               shape=spec.shape, stride=spec.stride)
        with _region(f"{ctx.region} backward"):
            return d.redistribute(spec.mesh, spec.placements), None


def sync_grad(g, param):
    """Gradient ``g`` at its parameter's placements: the partial sums
    over the data axes (and ``model``) reduced once."""
    if not is_dtensor(g) or g.placements == param.placements:
        return g
    with _region("gradient sync"):
        return g.redistribute(param.device_mesh, param.placements)


# ------------------------------ embedding ----------------------------------

def embed_lookup(table: DTensor, tokens, dtype):
    """``table[tokens]`` with the table's rows (the vocabulary) sharded
    on ``model``: each rank looks up the tokens in its rows, zeros the
    others, and the partial rows are all-reduced.  A table the vocabulary
    does not divide is whole on every rank, and so is the lookup."""
    if not is_dtensor(tokens):
        return table[tokens].to(dtype)
    lay = Layout(tokens)
    with _region("embed"):
        tok = lay.rows(tokens)
        if table.placements[lay.mi] != Shard(0):
            whole = lay.w_in(table, None, grad_model=Replicate())
            return lay.out(whole[tok].to(dtype))
        tab = lay.w_in(table, 0)
        v0 = lay.rank * tab.shape[0]
        local = tok - v0
        hit = (local >= 0) & (local < tab.shape[0])
        rows = tab[torch.where(hit, local, 0)] * hit[..., None]
        return lay.out(lay.reduce(rows).to(dtype))


# ------------------------------ attention ----------------------------------

def _span(lay: Layout, n: int) -> tuple[int, int]:
    """(first, count) of this rank's share of ``n`` heads or rows; all
    of them when ``model`` does not divide ``n``."""
    if n % lay.m:
        return 0, n
    return lay.rank * (n // lay.m), n // lay.m


def _cols(lay: Layout, w: DTensor, units: list[int], width: int):
    """Columns of units ``units`` (heads of ``width`` columns each) of
    ``w``: this rank's shard when it holds exactly those, else taken from
    the gathered weight (whose gradient is then a partial sum)."""
    n = len(units)
    total = w.shape[-1] // width
    if total % lay.m == 0 and n == total // lay.m \
            and units == list(range(lay.rank * n, (lay.rank + 1) * n)) \
            and w.placements[lay.mi] == Shard(w.ndim - 1):
        return lay.w_in(w, -1)
    whole = lay.w_in(w, None)
    if units == list(range(units[0], units[0] + n)):
        return whole[..., units[0] * width:(units[0] + n) * width]
    at = torch.cat([torch.arange(u * width, (u + 1) * width,
                                 device=whole.device) for u in units])
    return whole[..., at]


def _rows(lay: Layout, w: DTensor, units: list[int], width: int):
    """Rows of units ``units`` of ``w`` (the input side of an output
    projection), as ``_cols``."""
    n = len(units)
    total = w.shape[-2] // width
    if total % lay.m == 0 and n == total // lay.m \
            and units[0] == lay.rank * n \
            and w.placements[lay.mi] == Shard(w.ndim - 2):
        return lay.w_in(w, -2)
    return lay.w_in(w, None)[..., units[0] * width:(units[0] + n) * width, :]


def _head_weights(lay: Layout, p, cfg, bias: bool):
    """This rank's share of the heads, as the weights of a plain
    attention block and its config: heads [h0, h0 + H / m), and the kv
    heads they read (one per local head when the local heads do not
    split evenly over their kv heads)."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h0, Hl = _span(lay, H)
    g = H // KV
    heads = list(range(h0, h0 + Hl))
    kv = list(range(h0 // g, (h0 + Hl - 1) // g + 1))
    if Hl % len(kv) or any((h - h0) // (Hl // len(kv)) != h // g - kv[0]
                           for h in heads):
        kv = [h // g for h in heads]
    local = {"wq": _cols(lay, p["wq"], heads, hd),
             "wk": _cols(lay, p["wk"], kv, hd),
             "wv": _cols(lay, p["wv"], kv, hd),
             "wo": _rows(lay, p["wo"], heads, hd)}
    if bias:
        local.update(bq=_cols(lay, p["bq"], heads, hd),
                     bk=_cols(lay, p["bk"], kv, hd),
                     bv=_cols(lay, p["bv"], kv, hd))
    cfg = dataclasses.replace(cfg, n_heads=Hl, n_kv_heads=len(kv),
                              head_dim=hd)
    return local, cfg


def _whole(lay: Layout, p, names):
    """Weights ``names`` of ``p`` gathered whole, for a block every rank
    runs alike (their gradients are whole on every rank)."""
    return {n: lay.w_in(p[n], None, grad_model=Replicate())
            for n in names if n in p}


_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def attention(p, x: DTensor, cfg, pos, cache=None, window=0):
    """``layers.attention`` partitioned (``_full_pass``); a decode step
    over the cache's sequence shard."""
    from repro_torch.models import layers as L

    lay = Layout(x)
    if cache is not None:
        return _attention_decode(lay, p, x, cfg, pos, cache, window)
    with _region("attention"):
        posl = lay.rows(pos, 1 if cfg.pos == "mrope" else 0)
        return lay.out(_full_pass(
            lay, p, cfg, x, x, cfg.bias, posl, True, window,
            lambda w, xl, kvl, c: L.attention(w, xl, c, posl, None,
                                              window)[0])), None


def cross_attention(p, x: DTensor, kv: DTensor, cfg):
    """``models.model``'s ``_bidir_attention`` (``kv`` is ``x``) and
    ``_cross_attention`` partitioned (``_full_pass``): no mask, no RoPE,
    no biases."""
    from repro_torch.models import model as M

    def plain(w, xl, kvl, c):
        if kv is not x:
            return M._cross_attention(w, xl, kvl, c)
        full = torch.ones((xl.shape[0],) + xl.shape[1:2] * 2,
                          dtype=torch.bool, device=xl.device)
        return M._bidir_attention(w, xl, c, full)

    lay = Layout(x)
    with _region("attention"):
        return lay.out(_full_pass(lay, p, cfg, x, kv, False, None, False, 0,
                                  plain))


def _full_pass(lay: Layout, p, cfg, x, kv, bias: bool, posl, causal: bool,
               window: int, plain):
    """The local output of a full pass of attention of ``x``'s rows to
    ``kv``'s: ``plain(weights, x, kv, cfg)`` on this rank's heads when
    they divide ``model`` (its output a partial sum, reduced here), else
    on the whole weights on every rank when the rows do not divide
    either, else this rank's query rows (``_row_attention``)."""
    heads = cfg.n_heads % lay.m == 0
    if heads or x.shape[1] % lay.m:
        gm = Partial() if heads else Replicate()
        xl = lay.x_in(x, grad_model=gm)
        kvl = xl if kv is x else lay.x_in(kv, grad_model=gm)
        if heads:
            w, wcfg = _head_weights(lay, p, cfg, bias)
            return lay.reduce(plain(w, xl, kvl, wcfg))
        w = _whole(lay, p, _ATTN if bias else _ATTN[:4])
        return plain(w, xl, kvl, cfg)
    xl = lay.x_in(x)
    kvl = xl if kv is x else lay.x_in(kv)
    return _row_attention(lay, p, cfg, xl, kvl, posl, causal, window, bias)


def _row_attention(lay: Layout, p, cfg, xl, kvl, posl, causal: bool,
                   window: int, bias: bool):
    """Attention of this rank's S / m query rows of ``xl`` (every head)
    to every row of ``kvl``: the keys and values column-parallel and
    gathered, the rows gathered after the output projection."""
    from repro_torch.models import layers as L

    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Bl, S = xl.shape[:2]
    Sk = kvl.shape[1]
    r0, Sl = _span(lay, S)
    rows = slice(r0, r0 + Sl)
    q = xl[:, rows] @ lay.w_in(p["wq"], None)
    if bias:
        q = q + lay.w_in(p["bq"], None)
    k = _gathered_cols(lay, p, "wk", kvl, bias)
    v = _gathered_cols(lay, p, "wv", kvl, bias)
    q = q.reshape(Bl, Sl, H, hd)
    k = k.reshape(Bl, Sk, KV, hd)
    v = v.reshape(Bl, Sk, KV, hd)
    if posl is not None:
        q, k = L.rope_qk(q, k, posl[..., rows], posl, cfg)
    qi = torch.arange(r0, r0 + Sl, device=xl.device)
    mask = L.causal_mask(qi, Sk, window) if causal else \
        torch.ones((Sl, Sk), dtype=torch.bool, device=xl.device)
    o = L._sdpa(q, k, v, mask[None].expand(Bl, Sl, Sk))
    out = o.reshape(Bl, Sl, H * hd) @ lay.w_in(p["wo"], None)
    # the rows are the same on every rank downstream
    return lay.gather(out, 1, grad_model=Replicate())


def _attention_decode(lay: Layout, p, x, cfg, pos, cache, window):
    """One decode step over the cache's sequence shard on each rank: the
    new token's query, key and value column-parallel and gathered, the
    softmax split over the ranks' keys, the output row-parallel."""
    from repro_torch.models import layers as L

    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if x.shape[1] != 1:
        raise ValueError(f"a decode step takes one token, got {x.shape[1]}")
    with _region("attention"):
        xl = lay.x_in(x)
        posl = lay.rows(pos, 1 if cfg.pos == "mrope" else 0)
        Bl = xl.shape[0]
        q, k, v = (_gathered_cols(lay, p, n, xl, cfg.bias)
                   for n in ("wq", "wk", "wv"))
        q, k = L.rope_qk(q.reshape(Bl, 1, H, hd), k.reshape(Bl, 1, KV, hd),
                         posl, posl, cfg)
        v = v.reshape(Bl, 1, KV, hd)
        ck, cv = cache["k"].to_local(), cache["v"].to_local()
        s0, Sc = _cache_span(lay, cache["k"], 1)
        idx = int(cache["idx"])
        slot = L.cache_slot(idx, Sc, window)
        Sl = ck.shape[1]
        if s0 <= slot < s0 + Sl:
            ck[:, slot - s0] = k[:, 0]
            cv[:, slot - s0] = v[:, 0]
        valid = L.cache_valid(torch.arange(s0, s0 + Sl, device=xl.device),
                              idx, Sc, window)
        logits = L.attn_logits(q, ck, valid[None, None, :])
        o = L.attn_values(_split_softmax(lay, logits, Sl < Sc), cv)
        if Sl < Sc:
            o = lay.reduce(o)
        out = _row_parallel(lay, o.reshape(Bl, 1, H * hd), p["wo"])
    new_cache = {"k": cache["k"], "v": cache["v"], "idx": idx + 1}
    return lay.out(out), new_cache


def _gathered_cols(lay: Layout, p, name: str, xl, bias: bool):
    """x @ w[name] (+ its bias) whole: column-parallel on this rank's
    shard, then gathered over ``model`` (what is gathered is smaller than
    the products every rank would otherwise repeat)."""
    w = p[name]
    b = p["b" + name[1:]] if bias else None
    if w.placements[lay.mi] == Shard(w.ndim - 1):
        out = xl @ lay.w_in(w, -1)
        if b is not None:
            out = out + lay.w_in(b, -1)
        return lay.gather(out, -1)
    out = xl @ lay.w_in(w, None)
    return out + lay.w_in(b, None) if b is not None else out


def _row_parallel(lay: Layout, o, w):
    """o (replicated on ``model``) @ w, w's rows sharded on ``model``:
    each rank takes its rows of o, and the products are all-reduced."""
    if w.placements[lay.mi] == Shard(w.ndim - 2):
        wl = lay.w_in(w, -2)
        n = wl.shape[-2]
        return lay.reduce(o[..., lay.rank * n:(lay.rank + 1) * n] @ wl)
    return o @ lay.w_in(w, None, grad_model=Replicate())


def _cache_span(lay: Layout, c: DTensor, dim: int) -> tuple[int, int]:
    """(first global slot of this rank's shard, cache length) along
    ``dim`` of cache leaf ``c``."""
    Sc = c.shape[dim]
    if c.placements[lay.mi] == Shard(dim):
        return lay.rank * (Sc // lay.m), Sc
    return 0, Sc


def _split_softmax(lay: Layout, logits, split: bool):
    """softmax over the last dimension, whose keys are split across
    ``model`` when ``split``: the max and the sum are all-reduced (and
    the caller all-reduces the weighted values)."""
    if not split:
        return torch.softmax(logits, -1)
    mx = lay.reduce(logits.amax(-1, keepdim=True), "max")
    e = torch.exp(logits - mx)
    return e / lay.reduce(e.sum(-1, keepdim=True))


# --------------------------------- MLA --------------------------------------

def mla_attention(p, x: DTensor, cfg, pos, cache=None):
    """``layers.mla_attention`` partitioned as ``attention``: the plain
    block on this rank's heads (the latent projections whole on every
    rank), else over the query rows; a decode step over the cache's
    sequence shard."""
    from repro_torch.models import layers as L

    lay = Layout(x)
    m = cfg.mla
    H, S = cfg.n_heads, x.shape[1]
    qk = m.qk_nope_dim + m.qk_rope_dim
    latent = ("wq_a", "q_norm", "wkv_a", "kv_norm")
    with _region("mla"):
        posl = lay.rows(pos)
        if cache is None and (H % lay.m == 0 or S % lay.m):
            heads = H % lay.m == 0
            xl = lay.x_in(x, grad_model=Partial() if heads else Replicate())
            if heads:
                h0, Hl = _span(lay, H)
                units = list(range(h0, h0 + Hl))
                w = {n: lay.w_in(p[n], None) for n in latent}
                w.update(wq_b=_cols(lay, p["wq_b"], units, qk),
                         wkv_b=_cols(lay, p["wkv_b"], units,
                                     m.qk_nope_dim + m.v_head_dim),
                         wo=_rows(lay, p["wo"], units, m.v_head_dim))
                lcfg = dataclasses.replace(cfg, n_heads=Hl)
                out, _ = L.mla_attention(w, xl, lcfg, posl)
                return lay.out(lay.reduce(out)), None
            w = _whole(lay, p, latent + ("wq_b", "wkv_b", "wo"))
            return lay.out(L.mla_attention(w, xl, cfg, posl)[0]), None
        xl = lay.x_in(x)
        Bl = xl.shape[0]
        qa, c_kv, k_rope = L.mla_latents(
            {n: lay.w_in(p[n], None) for n in latent}, xl, m)
        k_rope = L.apply_rope(k_rope, posl, 1.0, cfg.rope_theta)
        if cache is None:
            # this rank's query rows of every head
            r0, Sl = _span(lay, S)
            rows = slice(r0, r0 + Sl)
            q = qa[:, rows] @ lay.w_in(p["wq_b"], None)
            mask = L.causal_mask(torch.arange(r0, r0 + Sl, device=xl.device),
                                 S)[None]
            split = False
        else:
            if S != 1:
                raise ValueError(f"a decode step takes one token, got {S}")
            rows = slice(0, 1)
            q = _gathered_cols(lay, p, "wq_b", qa, False)
            idx = int(cache["idx"])
            ckv, ckr = (cache[n].to_local() for n in ("c_kv", "k_rope"))
            s0, Sc = _cache_span(lay, cache["c_kv"], 1)
            Sl = ckv.shape[1]
            if s0 <= idx < s0 + Sl:
                ckv[:, idx - s0] = c_kv[:, 0]
                ckr[:, idx - s0] = k_rope[:, 0]
            c_kv, k_rope = ckv, ckr
            split = Sl < Sc
            mask = L.cache_valid(torch.arange(s0, s0 + Sl, device=xl.device),
                                 idx, Sc, 0)[None, None]
        q = q.reshape(Bl, -1, H, qk)
        q_rope = L.apply_rope(q[..., m.qk_nope_dim:], posl[:, rows], 1.0,
                              cfg.rope_theta)
        q = torch.cat([q[..., :m.qk_nope_dim], q_rope], -1)
        k, v = L.mla_keys(c_kv, k_rope, lay.w_in(p["wkv_b"], None), m)
        o = L.attn_values(_split_softmax(lay, L.attn_logits(q, k, mask),
                                         split), v)
        if split:
            o = lay.reduce(o)
        o = o.reshape(Bl, o.shape[1], H * m.v_head_dim)
        if cache is not None:
            out = _row_parallel(lay, o, p["wo"])
        else:
            out = lay.gather(o @ lay.w_in(p["wo"], None), 1,
                             grad_model=Replicate())
    new_cache = None if cache is None else {
        "c_kv": cache["c_kv"], "k_rope": cache["k_rope"],
        "idx": int(cache["idx"]) + 1}
    return lay.out(out), new_cache


# --------------------------------- MLP --------------------------------------

def mlp(p, x: DTensor, kind: str):
    """``layers.mlp``, column- then row-parallel on ``model`` (the plain
    block on this rank's hidden units, its output a partial sum)."""
    from repro_torch.models import layers as L

    lay = Layout(x)
    tp = p["up"].placements[lay.mi] == Shard(p["up"].ndim - 1)
    with _region("mlp"):
        xl = lay.x_in(x, grad_model=Partial() if tp else Replicate())
        if tp:
            w = {n: lay.w_in(p[n], -1) for n in ("up", "gate", "b_up")
                 if n in p}
            w["down"] = lay.w_in(p["down"], -2)
            out = lay.reduce(L.mlp(w, xl, kind))
        else:
            out = L.mlp(_whole(lay, p, ("up", "gate", "b_up", "down")), xl,
                        kind)
        if "b_down" in p:
            out = out + lay.w_in(p["b_down"], None, grad_model=Replicate())
        return lay.out(out)


# --------------------------------- MoE --------------------------------------

def moe(p, x: DTensor, mo, kind: str):
    """``layers.moe`` with each data shard's tokens dispatched where they
    are (see the module's docstring); the dense residual FFN runs as
    ``mlp``."""
    from repro_torch.models import layers as L

    lay = Layout(x)
    B, S, d = x.shape
    ep = p["up"].placements[lay.mi] == Shard(0)
    part = Partial() if ep else Replicate()
    with _region("moe"):
        xl = lay.x_in(x, grad_model=part)
        xt = xl.reshape(-1, d)
        router = lay.w_in(p["router"], None, grad_model=part)
        r = L.moe_route(router, xt, mo, n_tokens=B * S,
                        before=lambda counts: _counts_before(lay, counts))
        w = {n: lay.w_in(p[n], 0 if ep else None,
                         grad_model=None if ep else Replicate())
             for n in ("up", "gate", "down")}
        e0 = lay.rank * w["up"].shape[0] if ep else 0
        y = L.moe_experts(w, xt, r, e0).reshape(xl.shape)
        y = lay.out(lay.reduce(y) if ep else y)
    if "dense" in p:
        y = y + L.mlp(p["dense"], x, kind)
    return y


def _counts_before(lay: Layout, counts: torch.Tensor) -> torch.Tensor:
    """Per expert, the pairs of the data shards before this one (the
    counts are gathered over the axes the batch is sharded on)."""
    if lay.shards == 1:
        return torch.zeros_like(counts)
    pl = [Replicate()] * lay.mesh.ndim
    for i in lay.batch_dims:
        pl[i] = Shard(0)
    whole = DTensor.from_local(counts[None], lay.mesh, tuple(pl),
                               run_check=False)
    every = whole.redistribute(lay.mesh,
                               (Replicate(),) * lay.mesh.ndim).to_local()
    return every[:lay.shard].sum(0)


# ------------------------ collectives of the scans ---------------------------

def _all_to_all(t, out_splits, in_splits, group):
    return funcol.wait_tensor(funcol.all_to_all_single(
        t.contiguous(), out_splits, in_splits, group))


def _all_reduce(t, group):
    return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))


class _Regroup(torch.autograd.Function):
    """This rank's columns of every piece of a concatenation of ``parts``
    equal pieces whose columns are sharded on ``model`` as a whole (the
    ``[xi | z]`` of ``in_proj``, the ``[u | z]`` of ``up``, the ``[i | f
    | z | o]`` of sLSTM's gates): (..., parts * P / m) -> (..., parts *
    P / m), one all-to-all over ``model`` (GSPMD's plan moves the same
    columns with collective-permutes); its gradient the reverse one.

    Global chunk ``g`` of P / m columns lies on rank ``g // parts`` and
    belongs to piece ``g // m`` of rank ``g % m``."""

    @staticmethod
    def forward(ctx, lay: "Layout", t, parts: int):
        m, s = lay.m, lay.rank
        dest = [(s * parts + u) % m for u in range(parts)]
        order = sorted(range(parts), key=lambda u: dest[u])
        src = [(s + p * m) // parts for p in range(parts)]
        ctx.lay, ctx.order, ctx.region = lay, order, region_name()
        ctx.splits = ([src.count(r) for r in range(m)],
                      [dest.count(r) for r in range(m)])
        chunks = t.unflatten(-1, (parts, -1)).movedim(-2, 0)[order]
        got = _all_to_all(chunks, *ctx.splits, (lay.mesh, lay.mi))
        return got.movedim(0, -2).flatten(-2)

    @staticmethod
    def backward(ctx, g):
        recv, sent = ctx.splits
        parts = len(ctx.order)
        with _region(f"{ctx.region} backward"):
            back = _all_to_all(g.unflatten(-1, (parts, -1)).movedim(-2, 0),
                               sent, recv, (ctx.lay.mesh, ctx.lay.mi))
        out = torch.empty_like(back)
        out[ctx.order] = back
        return None, out.movedim(0, -2).flatten(-2), None


# (id of a mesh, k) -> (the mesh, its head-group mesh): made once a mesh,
# as making one makes process groups; keyed by the mesh object, not its
# layout (a mesh equal to one of a process group since destroyed is not it)
_GROUP_MESHES: dict = {}


def _group_mesh(lay: "Layout", k: int):
    """``lay``'s mesh with ``model`` split into (m / k, k): the second
    axis runs over the k consecutive ``model`` ranks that share a head."""
    key = (id(lay.mesh), k)
    if key not in _GROUP_MESHES:
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.device_mesh import DeviceMesh

        names = list(lay.mesh.mesh_dim_names)
        names[lay.mi:lay.mi + 1] = [f"{MODEL}_heads", f"{MODEL}_in_head"]
        # the mesh's rank tensor is a real one (the dry run's step runs
        # under a fake tensor mode)
        with unset_fake_temporarily():
            ranks = lay.mesh.mesh
            shape = list(ranks.shape)
            shape[lay.mi:lay.mi + 1] = [lay.m // k, k]
            _GROUP_MESHES[key] = (lay.mesh, DeviceMesh(
                lay.mesh.device_type, ranks.reshape(shape),
                mesh_dim_names=tuple(names)))
    return _GROUP_MESHES[key][1], lay.mi + 1


class _GroupSum(torch.autograd.Function):
    """The sum of a head's partials over the ranks that share the head
    (each holds a slice of its dims); its consumers are alike on those
    ranks, so the gradient passes back as it is."""

    @staticmethod
    def forward(ctx, t, group):
        return _all_reduce(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GroupGrad(torch.autograd.Function):
    """The identity on a value that the ranks sharing a head hold alike
    and use each on its slice of the head's dims: the gradient is summed
    over those ranks."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.region = group, region_name()
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        with _region(f"{ctx.region} backward"):
            return _all_reduce(g, ctx.group), None


class _GroupOnce(torch.autograd.Function):
    """The identity on a value that every ``model`` rank holds alike but
    only the ranks of one head group use, alike: one rank of the group
    passes the gradient back, so that a sum over ``model`` counts it
    once."""

    @staticmethod
    def forward(ctx, t, first: bool):
        ctx.first = first
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def _next_cache(cache, names):
    """A decode step's new cache: the same state leaves (updated in place)
    and the next index."""
    return None if cache is None else {
        **{n: cache[n] for n in names}, "idx": int(cache["idx"]) + 1}


# --------------------------------- Mamba ------------------------------------

_MAMBA = ("in_proj", "conv_w", "x_proj", "dt_bias", "A_log", "D", "out_proj")


def mamba(p, x: DTensor, cfg, cache=None):
    """``layers.mamba`` with its channels split over ``model``: the
    column-parallel ``in_proj`` regrouped so that each rank holds the
    ``xi`` and ``z`` of its channels (``_Regroup``), the convolution and
    the scan on those channels (no collective inside the scan), the
    row-parallel ``x_proj`` (a partial of dt, B and C, all-reduced) and
    ``out_proj`` (all-reduced); a decode step updates this rank's shard
    of the ``conv`` and ``ssm`` states.  Raises when ``model`` does not
    divide the channels."""
    from repro_torch.models import layers as L

    lay = Layout(x)
    di = cfg.mamba_expand * cfg.d_model
    if cache is not None and x.shape[1] != 1:
        raise ValueError(f"a decode step takes one token, got {x.shape[1]}")
    lay.channels("mamba", p["in_proj"], di)
    with _region("mamba"):
        xl = lay.x_in(x)
        xz = _Regroup.apply(lay, xl @ lay.sharded(p["in_proj"], -1), 2)
        xi, z = xz.chunk(2, -1)
        u = L.mamba_conv(xi, lay.sharded(p["conv_w"], -1),
                         None if cache is None
                         else lay.state(cache["conv"], -1))
        proj = lay.reduce(u @ lay.sharded(p["x_proj"], -2),
                          grad_model=Partial())
        w = {"dt_bias": lay.sharded(p["dt_bias"], -1),
             "A_log": lay.sharded(p["A_log"], -2),
             "D": lay.sharded(p["D"], -1)}
        y = L.mamba_scan(w, u, z, proj, cfg.mamba_d_state,
                         None if cache is None
                         else lay.state(cache["ssm"], -2))
        out = lay.reduce(y @ lay.sharded(p["out_proj"], -2))
    return lay.out(out), _next_cache(cache, ("conv", "ssm"))


# --------------------------------- xLSTM ------------------------------------

_MLSTM = ("up", "wq", "wk", "wv", "wif", "down")


def mlstm(p, x: DTensor, cfg, cache=None):
    """``layers.mlstm`` with its inner channels split over ``model``, as
    GSPMD's plan splits them: ``up`` column-parallel and regrouped into
    this rank's ``u`` and ``z`` channels, ``u`` gathered for the
    column-parallel q, k and v, the gates row-parallel (all-reduced).
    In the parallel form each rank holds its columns of q, k and v:
    whole heads when the heads divide ``model``; else a slice of one
    head's dims, whose logits are summed over the ranks that share the
    head and whose weights' gradient is summed back over them.  The
    output is row-parallel through ``down`` (all-reduced).  A decode step
    gathers q, k and v, updates this rank's shard of ``C`` (its value
    dims) and ``n`` (its key dims), all-reduces n . q and gathers C q.
    Every rank runs the whole block when ``model`` and the heads divide
    neither each other (in the parallel form; the decode step splits
    the channels all the same), and the region raises when ``model``
    does not divide the channels."""
    from repro_torch.models import layers as L

    lay = Layout(x)
    B, S, d = x.shape
    if cache is not None and S != 1:
        raise ValueError(f"a decode step takes one token, got {S}")
    di, H = cfg.mamba_expand * d, cfg.n_heads
    hd = di // H
    lay.channels("mlstm", p["up"], di)
    split = cache is not None or H % lay.m == 0 or lay.m % H == 0
    with _region("mlstm"):
        if not split:  # the parallel form; decode splits in any case
            out, _ = L.mlstm(_whole(lay, p, _MLSTM),
                             lay.x_in(x, grad_model=Replicate()), cfg)
            return lay.out(out), None
        xl = lay.x_in(x)
        uz = _Regroup.apply(lay, xl @ lay.sharded(p["up"], -1), 2)
        u_r, z = uz.chunk(2, -1)
        u = lay.gather(u_r, -1)
        gates = u_r @ lay.sharded(p["wif"], -2).to(u.dtype)
        if cache is None:
            ig, fg = L.mlstm_gates(lay.reduce(gates, grad_model=Partial()), H)
            out = _mlstm_parallel(lay, p, u, ig, fg, H, hd)
        else:
            ig, fg = L.mlstm_gates(lay.reduce(gates), H)
            out = _mlstm_decode(lay, p, u, ig, fg, H, hd, cache, x.dtype)
        out = out.reshape(*z.shape[:2], -1) * torch.nn.functional.silu(z)
        out = lay.reduce(out @ lay.sharded(p["down"], -2))
    return lay.out(out), _next_cache(cache, ("C", "n"))


def _mlstm_parallel(lay: Layout, p, u, ig, fg, H: int, hd: int):
    """The parallel form on this rank's columns of q, k and v: heads
    [h0, h0 + hl), or (hl = 1) a slice of head h0's dims."""
    from repro_torch.models import layers as L

    hl = max(H // lay.m, 1)
    h0 = lay.rank * H // lay.m
    q, k, v = L.mlstm_heads(*(u @ lay.sharded(p[n], -1)
                              for n in ("wq", "wk", "wv")), hl, hd)
    ig, fg = ig[..., h0:h0 + hl], fg[..., h0:h0 + hl]
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k)
    share = lay.m // H if lay.m > H else 1
    if share > 1:
        group = _group_mesh(lay, share)
        s = _GroupSum.apply(s, group)
        first = lay.rank % share == 0
        ig, fg = _GroupOnce.apply(ig, first), _GroupOnce.apply(fg, first)
    w = L.mlstm_weights(s, ig, fg).to(v.dtype)
    if share > 1:
        w = _GroupGrad.apply(w, group)
    return torch.einsum("bhqs,bshd->bqhd", w, v)


def _mlstm_decode(lay: Layout, p, u, ig, fg, H: int, hd: int, cache, dtype):
    """One recurrent step on this rank's shards of ``C`` (value dims)
    and ``n`` (key dims); returns this rank's output columns."""
    from repro_torch.models import layers as L

    q, k, v = L.mlstm_heads(*(lay.gather(u @ lay.sharded(p[n], -1), -1)
                              for n in ("wq", "wk", "wv")), H, hd)
    C, n = (cache[name] for name in ("C", "n"))
    cs = C.placements[lay.mi] == Shard(C.ndim - 2)
    ns = n.placements[lay.mi] == Shard(n.ndim - 1)
    Cl = lay.state(C, -2 if cs else None)
    nl = lay.state(n, -1 if ns else None)
    c0, n0 = (lay.rank * Cl.shape[-2] if cs else 0,
              lay.rank * nl.shape[-1] if ns else 0)
    i_t, f_t = torch.exp(ig[:, 0]), torch.exp(fg[:, 0])
    k0, q0 = k[:, 0], q[:, 0].float()
    v0 = v[:, 0].float()[..., c0:c0 + Cl.shape[-2]]
    Cn, num = L.mlstm_matrix_step(Cl, k0, v0, q0, i_t, f_t)
    kn, qn = (t[..., n0:n0 + nl.shape[-1]] for t in (k0, q0))
    nn_, nq = L.mlstm_norm_step(nl, kn, qn, i_t, f_t)
    if cs:
        num = lay.gather(num, -1)
    if ns:
        nq = lay.reduce(nq)
    Cl.copy_(Cn)
    nl.copy_(nn_)
    out = (num / nq.abs().clamp_min(1.0)[..., None]).to(dtype)[:, None]
    w = out.shape[-1] * H // lay.m
    return out.flatten(-2)[..., lay.rank * w:(lay.rank + 1) * w]


def slstm(p, x: DTensor, cfg, cache=None):
    """``layers.slstm`` with its channels split over ``model``: ``w``
    and ``r`` column-parallel, the gates of each step regrouped into this
    rank's channels of i, f, z and o (``_Regroup``), the cell on those
    channels, and ``h`` gathered for the next step's ``h @ r``; the
    outputs are gathered once after the scan.  A decode step updates this
    rank's shard of the ``h`` and ``c`` states.  Raises when ``model``
    does not divide the channels."""
    from repro_torch.models import layers as L

    lay = Layout(x)
    B, S, d = x.shape
    if cache is not None and S != 1:
        raise ValueError(f"a decode step takes one token, got {S}")
    lay.channels("slstm", p["w"], d)
    lay.channels("slstm", p["r"], d)
    with _region("slstm"):
        xl = lay.x_in(x)
        w, r = lay.sharded(p["w"], -1), lay.sharded(p["r"], -1)

        def step(xt, h, c):
            # float32, as the reference casts the gates before it splits
            # them: GSPMD's plan permutes them in f32 (the while body's
            # collective-permutes, tools/reference_collectives.py)
            g = _Regroup.apply(lay, (xt @ w + h @ r).float(), 4)
            return L.slstm_cell(g, c, x.dtype)

        if cache is None:
            h = torch.zeros((xl.shape[0], d), dtype=x.dtype, device=xl.device)
            c = torch.zeros((xl.shape[0], d // lay.m), dtype=torch.float32,
                            device=xl.device)
            hs = []
            for t in range(S):
                h_r, c = step(xl[:, t], h, c)
                hs.append(h_r)
                if t + 1 < S:
                    h = lay.gather(h_r, -1)
            # the outputs are alike on every rank downstream
            out = lay.gather(torch.stack(hs, 1), -1, grad_model=Replicate())
            return lay.out(out), None
        hl, cl = lay.state(cache["h"], -1), lay.state(cache["c"], -1)
        h_r, c = step(xl[:, 0], lay.gather(hl, -1), cl)
        hl.copy_(h_r)
        cl.copy_(c)
        out = lay.gather(h_r, -1)[:, None]
    return lay.out(out), _next_cache(cache, ("h", "c"))


# ------------------------- loss and greedy decoding -------------------------

def head_logits(x: DTensor, head: DTensor):
    """float32 ``x @ head`` with the head's columns (the vocabulary)
    sharded on ``model``: column-parallel, so the logits stay sharded
    on the vocabulary and the gradient of ``x`` is reduced once."""
    lay = Layout(x)
    with _region("head"):
        if head.placements[lay.mi] != Shard(head.ndim - 1):
            # a vocabulary ``model`` does not divide: whole on every rank
            xl = lay.x_in(x, grad_model=Replicate())
            whole = lay.w_in(head, None, grad_model=Replicate())
            return lay.out((xl @ whole).float())
        xl = lay.x_in(x)
        out = (xl @ lay.w_in(head, -1)).float()
        return lay.out(out, model=Shard(out.ndim - 1))


def token_log_likelihood(logits: DTensor, labels, ce_impl: str):
    """``logits[label] - logsumexp(logits)`` per position, with the
    vocabulary sharded on ``model``: the max and the sum of exps are
    all-reduced over ``model`` as (B, S) partials, and so is the picked
    logit (a masked local gather)."""
    lay = Layout(logits)
    vocab_split = logits.placements[lay.mi] == Shard(logits.ndim - 1)
    with _region("loss"):
        if vocab_split:
            ll = _split_log_likelihood(lay, logits, labels, ce_impl)
        else:
            from repro_torch.models.steps import log_likelihood

            ll = log_likelihood(lay.x_in(logits, grad_model=Replicate()),
                                lay.rows(labels), ce_impl)
        return lay.out(ll)


def _split_log_likelihood(lay: Layout, logits, labels, ce_impl):
    lg = logits.redistribute(
        lay.mesh, lay.act(0, Shard(logits.ndim - 1))).to_local()
    Vl = lg.shape[-1]
    mx = lay.reduce(lg.detach().amax(-1, keepdim=True), "max")
    se = lay.reduce(torch.exp(lg - mx).sum(-1, keepdim=True))
    lse = mx + torch.log(se)
    local = lay.rows(labels).clamp_min(0) - lay.rank * Vl
    hit = (local >= 0) & (local < Vl)
    at = torch.where(hit, local, 0)[..., None]
    if ce_impl == "softmax":
        picked = (lg - lse).gather(-1, at)[..., 0] * hit
        return lay.reduce(picked)
    picked = lg.gather(-1, at)[..., 0] * hit
    return lay.reduce(picked) - lse[..., 0]


def greedy_tokens(logits: DTensor) -> DTensor:
    """``argmax(logits, -1)`` as int32, the vocabulary sharded on
    ``model``: each rank's best (value, index) is gathered and the
    first best wins, as ``torch.argmax`` picks."""
    lay = Layout(logits)
    with _region("argmax"):
        if logits.placements[lay.mi] != Shard(logits.ndim - 1):
            return lay.out(torch.argmax(lay.rows(logits), -1).to(torch.int32))
        pl = lay.act(0, Shard(logits.ndim - 1))
        lg = logits.redistribute(lay.mesh, pl).to_local()
        best, at = lg.max(-1, keepdim=True)
        at = at + lay.rank * lg.shape[-1]
        vals = lay.gather(best, -1)
        ats = lay.gather(at, -1)
        win = torch.argmax(vals, -1, keepdim=True)
        return lay.out(ats.gather(-1, win)[..., 0].to(torch.int32))

