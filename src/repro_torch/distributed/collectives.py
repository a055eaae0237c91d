"""Distributed paged-decode attention and cache writes on
``torch.distributed`` (port of ``repro.distributed.collectives``).

The JAX package wraps each function in ``shard_map``; here every rank
runs the body on the tensors it holds, and the collectives are explicit
calls on the mesh axes' process groups.  Three decode schemes:

  * ``tp``  — q and kv heads over "model": each rank's pools hold only its
    kv heads, and its attention is the single-device op (K1 + K2) over
    them;
  * ``dp``  — for windowed (bounded-ring) layers: pools replicated over
    "model", q-head groups over "model" when they divide, else
    replicated; again the single-device op;
  * ``kvp`` — flash-decoding over ranks: the pages are striped round-robin
    over every mesh axis not used for batch.  Local slot j of stripe s
    holds logical page j·n + s, so a row's live tokens on stripe s are a
    **prefix** of its local slots, ``local_lens`` long: K1 runs unchanged
    on the local table with those lengths, and ``merge_flash_partials``
    merges every rank's (m, l, acc) — by default with K2 over all ranks'
    splits (``"kernel"``), or with an all-reduce max and sum
    (``"plain"``).

Table layout: tables are (B, n_kv_shards, pages_per_shard); a rank holds
its own (B_local, 1, pages_per_shard) slice.  Under ``tp``/``dp``/local,
n_kv_shards == 1 and slots are logical pages.

Outside a mesh every function is the plain local call.

Collectives on a ``gloo`` group over CUDA tensors: gloo runs some
collectives on CUDA tensors and refuses others, and its point-to-point
ops read the tensor's raw pointer as host memory.  The first collective
probes ``all_reduce``, ``all_gather``, ``all_to_all`` and
``reduce_scatter`` on CUDA tensors (``probe``); an op gloo refuses or
gets wrong, and every point-to-point op, is copied through host memory
explicitly, in the gloo branch only, and counted in the mesh's
``host_copies`` (the compute never leaves the card).  NCCL groups take
CUDA tensors as they are.  The mesh's ``stats`` count each op's calls,
bytes and host seconds.

Under autograd: Megatron's f and g, the vocab gather,
``gather_dim``, the gather of a piece along a dim (FSDP's weights over
"data", the q heads of a ``"q_heads"`` layer over "model", the
sequence before a column-parallel product), whose backward is the
reduce-scatter of the gradient, its dual ``scatter_dim`` (the
reduce-scatter after a row-parallel product under sequence
parallelism, whose backward gathers), ``split_dim`` (a rank's piece of
what every rank computed whole; its backward gathers too),
``ring_pass``, the ring's send to the next rank, whose backward sends
to the previous one, and ``exchange``, the all-to-all of expert
parallelism, whose backward is the all-to-all of the gradient.

On a dry mesh (``launch.mesh.make_dry_mesh``) the group is a
``sharding.DryGroup``: each helper allocates what the real call
allocates and returns a tensor of the real result's shape and dtype,
sends nothing, and records the op, its bytes and the group in the mesh's
``stats`` (the dry run's collective accounting, ``launch.cost_analysis``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import attention as core_attn
from repro_torch.core import cache as kvcache
from repro_torch.distributed.sharding import (DryGroup, batch_axes_for,
                                              current_mesh, use_mesh)
from repro_torch.errors import EngineConfigError, UnsupportedFeature

COMBINE_MODES = ("kernel", "plain")


# ---------------------------------------------------------------------------
# collectives over mesh axes
# ---------------------------------------------------------------------------
def _group(axes: Sequence[str]):
    mesh = current_mesh()
    return None if mesh is None else mesh.group(tuple(axes))


def _is_gloo(group) -> bool:
    import torch.distributed as dist
    return dist.get_backend(group) == "gloo"


def probe(group, device: torch.device) -> set:
    """The ops of ``all_reduce``, ``all_gather``, ``all_to_all`` and
    ``reduce_scatter`` that raise or give a wrong result on small CUDA
    tensors of ``group``.  Collective: every member calls it at the same
    point (the first collective any of them makes)."""
    import torch.distributed as dist
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = torch.full((n, 4), float(r + 1), device=device)

    def reduced():
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    checks = {
        "all_reduce": (reduced, torch.full((n, 4), n * (n + 1) / 2)),
        "all_gather": (lambda: torch.stack(_gather_list(x, group)),
                       torch.arange(1, n + 1, dtype=torch.float32)
                       [:, None, None].expand(n, n, 4)),
        "all_to_all": (lambda: _a2a(x, group),
                       torch.arange(1, n + 1, dtype=torch.float32)
                       [:, None].expand(n, 4)),
        "reduce_scatter": (lambda: _rs(x, group),
                           torch.full((1, 4), n * (n + 1) / 2)),
    }
    refused = set()
    for op, (fn, want) in checks.items():
        try:
            ok = torch.equal(fn().cpu(), want.float())
        except (RuntimeError, ValueError, NotImplementedError):
            ok = False
        if not ok:
            refused.add(op)
    return refused


def _host(op: str, t: torch.Tensor, group) -> bool:
    """Whether ``op`` on ``t`` goes through host memory: only on a gloo
    group with a CUDA tensor, for the point-to-point ops and the probed
    ops gloo refused; each such call is counted in the mesh's
    ``host_copies``."""
    if not t.is_cuda or not _is_gloo(group):
        return False
    mesh = current_mesh()
    if op != "send_recv":
        if mesh.host_ops is None:
            mesh.host_ops = probe(group, t.device)
        if op not in mesh.host_ops:
            return False
    mesh.host_copies[op] += 1
    return True


def _count(op: str, t: torch.Tensor, t0: float) -> None:
    stats = current_mesh().stats
    stats["calls"][op] += 1
    stats["bytes"][op] += t.numel() * t.element_size()
    stats["seconds"][op] += time.perf_counter() - t0


def _dry(op: str, x: torch.Tensor, group: DryGroup,
         dim: Optional[int] = None) -> torch.Tensor:
    """The result of ``op`` on ``x`` over a dry ``group``, unsent: new
    tensors as the real call allocates them (``all_reduce``: a clone;
    ``all_gather``: n tensors like ``x``, stacked, or with ``dim`` joined
    along it; ``reduce_scatter``: the rank's 1/n of dim 0; ``all_to_all``
    and ``send_recv``: one like ``x``), recorded in the mesh's
    ``stats``."""
    if op == "all_reduce":
        out = x.clone()
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(group.size)]
        out = torch.stack(parts) if dim is None else torch.cat(parts, dim)
        del parts
    elif op == "reduce_scatter":
        out = x.new_empty((x.shape[0] // group.size, *x.shape[1:]))
    else:
        out = torch.empty_like(x)
    stats = current_mesh().stats
    nbytes = x.numel() * x.element_size()
    stats["calls"][op] += 1
    stats["bytes"][op] += nbytes
    stats["ops"].append((op, nbytes, group.size, group.ranks))
    return out


def _call(fn, outs, ins) -> None:
    """``fn(outs, ins)``, a gloo or NCCL call that writes ``outs`` (read
    as well: an all-reduce's) from ``ins``.  On host tensors it runs on
    private copies, outside the dispatch modes, and ``outs`` take the
    result: gloo's worker thread drops its references to a finished
    call's tensors only after the caller has resumed, and allocates
    scratch inside some calls, so the storages a step holds (the dry
    run's count, ``launch.cost_analysis``) would otherwise follow the
    thread's timing.  On CUDA tensors the call runs as it is."""
    if outs[0].is_cuda:
        fn(outs, ins)
        return
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        own = [t.clone() for t in outs]
        fn(own, [t.clone() for t in ins])
        for t, c in zip(outs, own):
            t.copy_(c)


def _gather_list(x, group):
    import torch.distributed as dist
    out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _call(lambda o, i: dist.all_gather(o, i[0], group=group), out,
          [x.contiguous()])
    return out


def _a2a(x, group):
    import torch.distributed as dist
    out = torch.empty_like(x)
    _call(lambda o, i: dist.all_to_all_single(o[0], i[0], group=group),
          [out], [x.contiguous()])
    return out


def _rs(x, group):
    """``reduce_scatter_tensor`` of ``x`` (n blocks along dim 0): the sum
    of every rank's block at this rank's index."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    _call(lambda o, i: dist.reduce_scatter_tensor(o[0], i[0], group=group),
          [out], [x.contiguous()])
    return out


def all_reduce(x: torch.Tensor, axes: Sequence[str], op: str = "sum"
               ) -> torch.Tensor:
    """``x`` reduced (``"sum"`` or ``"max"``) over the mesh ``axes``; the
    result is a new tensor (``x`` itself when no rank shares them)."""
    group = _group(axes)
    if group is None:
        return x
    if isinstance(group, DryGroup):
        return _dry("all_reduce", x, group)
    import torch.distributed as dist
    t0 = time.perf_counter()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if _host("all_reduce", x, group):
        y = x.cpu()
        dist.all_reduce(y, op=red, group=group)
        y = y.to(x.device)
    else:
        y = x.clone()
        _call(lambda o, _: dist.all_reduce(o[0], op=red, group=group), [y],
              [])
    _count("all_reduce", x, t0)
    return y


def all_gather(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` over the mesh ``axes``, in the
    ranks' row-major order over those axes."""
    group = _group(axes)
    if group is None:
        return x[None]
    if isinstance(group, DryGroup):
        return _dry("all_gather", x, group)
    t0 = time.perf_counter()
    if _host("all_gather", x, group):
        out = torch.stack(_gather_list(x.cpu(), group)).to(x.device)
    else:
        out = torch.stack(_gather_list(x, group))
    _count("all_gather", x, t0)
    return out


def all_gather_dim(x: torch.Tensor, axes: Sequence[str], dim: int
                   ) -> torch.Tensor:
    """Every rank's ``x`` over the mesh ``axes`` joined along ``dim``, in
    the ranks' row-major order over those axes (the whole of a tensor
    cut along ``dim``)."""
    group = _group(axes)
    if group is None:
        return x
    if isinstance(group, DryGroup):
        return _dry("all_gather", x, group, dim)
    t0 = time.perf_counter()
    if _host("all_gather", x, group):
        # the pieces back on x's device before they are joined, as the
        # direct call holds them (the dry run's count of the card's peak)
        out = torch.cat([p.to(x.device) for p in _gather_list(
            x.cpu(), group)], dim)
    else:
        out = torch.cat(_gather_list(x, group), dim)
    _count("all_gather", x, t0)
    return out


def reduce_scatter(x: torch.Tensor, axes: Sequence[str], dim: int = 0
                   ) -> torch.Tensor:
    """The sum of every rank's ``x`` over the mesh ``axes``, of which this
    rank keeps its piece along ``dim`` (the n equal blocks of ``dim`` in
    the ranks' row-major order over the axes): the inverse of
    ``all_gather_dim``'s layout, in one collective (through host memory
    where gloo refuses it on CUDA tensors)."""
    group = _group(axes)
    if group is None:
        return x
    src = x.movedim(dim, 0).contiguous()
    if isinstance(group, DryGroup):
        out = _dry("reduce_scatter", src, group)
    else:
        t0 = time.perf_counter()
        if _host("reduce_scatter", x, group):
            out = _rs(src.cpu(), group).to(x.device)
        else:
            out = _rs(src, group)
        _count("reduce_scatter", src, t0)
    del src
    return out.movedim(0, dim).contiguous()


def all_to_all(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``all_to_all_single`` over the mesh ``axes``: dim 0 of ``x`` is
    cut into n equal blocks, block j goes to rank j, and the result holds
    rank i's block for this rank at block i."""
    group = _group(axes)
    if group is None:
        return x
    if isinstance(group, DryGroup):
        return _dry("all_to_all", x, group)
    t0 = time.perf_counter()
    if _host("all_to_all", x, group):
        out = _a2a(x.cpu(), group).to(x.device)
    else:
        out = _a2a(x, group)
    _count("all_to_all", x, t0)
    return out


def ring_shift(x: torch.Tensor, axes: Sequence[str], step: int = 1
               ) -> torch.Tensor:
    """Send ``x`` to the rank ``step`` ahead over the mesh ``axes`` and
    return the one from the rank ``step`` behind (``batch_isend_irecv``;
    the JAX ``ppermute`` with ``j → j + 1`` at ``step`` 1, its transpose
    at -1)."""
    group = _group(axes)
    if group is None:
        return x
    if isinstance(group, DryGroup):
        return _dry("send_recv", x, group)
    import torch.distributed as dist
    t0 = time.perf_counter()
    n, r = dist.get_world_size(group), dist.get_rank(group)
    send = x.contiguous()
    host = _host("send_recv", x, group)
    if host:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (r - step) % n), group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    _count("send_recv", x, t0)
    return recv.to(x.device) if host else recv


def spans(axes: Sequence[str]) -> bool:
    """Whether more than one rank of the active mesh shares ``axes``."""
    return bool(axes) and _group(axes) is not None


# ---------------------------------------------------------------------------
# the collectives under autograd (Megatron's f and g, the vocab gather, the
# gather of a piece along a dim and the all-to-all)
# ---------------------------------------------------------------------------
# A Function whose backward makes a collective keeps the mesh its forward
# ran under: the autograd engine runs a CUDA backward on a thread of its
# own, where no mesh is active.  Under ``no_grad`` each one is its
# forward, the plain collective above.
class _ReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes):
        return all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed.sharding import use_mesh
        with use_mesh(ctx.mesh):
            return all_reduce(g.contiguous(), ctx.axes), None, None


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.lo, ctx.w = mesh.flat_index(axes) * x.shape[-1], x.shape[-1]
        return torch.cat(list(all_gather(x, axes)), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.lo, ctx.w).contiguous(), None, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, summed, mesh):
        ctx.axes, ctx.dim, ctx.summed, ctx.mesh = axes, dim, summed, mesh
        ctx.lo, ctx.w = mesh.flat_index(axes) * x.shape[dim], x.shape[dim]
        return all_gather_dim(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed.sharding import use_mesh
        if not ctx.summed:
            return (g.narrow(ctx.dim, ctx.lo, ctx.w).contiguous(), None,
                    None, None, None)
        with use_mesh(ctx.mesh):
            return (reduce_scatter(g, ctx.axes, ctx.dim), None, None, None,
                    None)


class _ScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, mesh):
        ctx.axes, ctx.dim, ctx.mesh = axes, dim, mesh
        return reduce_scatter(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed.sharding import use_mesh
        with use_mesh(ctx.mesh):
            return (all_gather_dim(g.contiguous(), ctx.axes, ctx.dim), None,
                    None, None)


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, mesh):
        ctx.axes, ctx.dim, ctx.mesh = axes, dim, mesh
        w = x.shape[dim] // mesh.prod(axes)
        return x.narrow(dim, mesh.flat_index(axes) * w, w).contiguous()

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed.sharding import use_mesh
        with use_mesh(ctx.mesh):
            return (all_gather_dim(g.contiguous(), ctx.axes, ctx.dim), None,
                    None, None)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return ring_shift(x, axes)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed.sharding import use_mesh
        with use_mesh(ctx.mesh):
            return ring_shift(g, ctx.axes, step=-1), None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.axes, ctx.mesh = axes, mesh
        return all_to_all(x, axes)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.distributed.sharding import use_mesh
        with use_mesh(ctx.mesh):
            return all_to_all(g.contiguous(), ctx.axes), None, None


def gather_dim(x: torch.Tensor, axes: Sequence[str], dim: int,
               summed: bool = True) -> torch.Tensor:
    """The whole of ``x``, this rank's piece along ``dim`` of a tensor cut
    over the mesh ``axes`` (``all_gather_dim``).  Under autograd the
    gradient of the whole comes back as this rank's piece: with
    ``summed``, of its sum over the axes (``reduce_scatter``: the ranks
    along them computed on different rows, FSDP's weight gather, or only
    on their own piece, the q heads of a ``"q_heads"`` decode), else the
    rank's own slice (every rank computed the same whole)."""
    if _group(axes) is None:
        return x
    return _GatherDim.apply(x, _mesh_order(axes), dim, summed,
                            current_mesh())


def _mesh_order(axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in current_mesh().axis_names if a in tuple(axes))


def scatter_dim(x: torch.Tensor, axes: Sequence[str], dim: int
                ) -> torch.Tensor:
    """The sum of every rank's ``x`` over the mesh ``axes``, of which this
    rank keeps its piece along ``dim`` (``reduce_scatter``): the dual of
    ``gather_dim``.  Under autograd the gradient of the piece comes back
    whole (``all_gather_dim``): Megatron-SP's reduce-scatter after a
    row-parallel product, whose every rank's partial sums feed every
    rank's piece."""
    if _group(axes) is None:
        return x
    return _ScatterDim.apply(x, _mesh_order(axes), dim, current_mesh())


def split_dim(x: torch.Tensor, axes: Sequence[str], dim: int
              ) -> torch.Tensor:
    """This rank's piece along ``dim`` of ``x``, a whole tensor that every
    rank over the mesh ``axes`` computed alike; under autograd the
    gradient of the whole is every rank's piece's, gathered
    (``all_gather_dim``), so that each rank again holds the whole
    cotangent of a computation it ran whole."""
    if _group(axes) is None:
        return x
    return _SplitDim.apply(x, _mesh_order(axes), dim, current_mesh())


def ring_pass(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``ring_shift`` (to the next rank); under autograd the gradient goes
    back the other way, to the rank it came from (both recorded on a dry
    mesh)."""
    if _group(axes) is None:
        return x
    return _RingShift.apply(x, tuple(axes), current_mesh())


def reduce_sum(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``x`` summed over the mesh ``axes``; under autograd its gradient
    passes through as it is (Megatron's g: after a row-parallel product,
    the vocab-sharded lookup, and the per-rank statistics of a loss that
    every rank then computes whole)."""
    if _group(axes) is None:
        return x
    return _ReduceSum.apply(x, tuple(axes))


def copy_in(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``x`` as it is; under autograd its gradient is summed over the mesh
    ``axes`` (Megatron's f: the input of a column-parallel product, and a
    replicated weight that feeds only this rank's part)."""
    if _group(axes) is None or not torch.is_grad_enabled():
        return x
    return _CopyIn.apply(x, tuple(axes), current_mesh())


def exchange(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """``all_to_all`` over the mesh ``axes`` (dim 0 of ``x`` in n equal
    blocks, block j to rank j); under autograd the gradient takes the way
    back, the same all-to-all of the cotangent (block i to the rank that
    sent block i), and on a dry mesh both are recorded."""
    if _group(axes) is None:
        return x
    return _Exchange.apply(x, tuple(axes), current_mesh())


def gather_last(x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
    """Every rank's ``x`` over the mesh ``axes`` joined along the last dim
    (the vocab gather of the logits); under autograd the gradient of the
    whole is cut back to this rank's columns."""
    if _group(axes) is None:
        return x
    return _GatherLast.apply(x, tuple(axes), current_mesh())


# ---------------------------------------------------------------------------
# flash-decoding merge
# ---------------------------------------------------------------------------
def resolve_combine_mode(mode: Optional[str], n_shards: int) -> str:
    """``None`` → "kernel" when more than one rank takes part, else
    "plain" (the JAX ``resolve_combine_mode``'s rule); anything but
    "kernel" and "plain" raises ``EngineConfigError``."""
    if mode is None:
        return "kernel" if n_shards > 1 else "plain"
    if mode not in COMBINE_MODES:
        raise EngineConfigError(f"combine_mode must be one of "
                                f"{COMBINE_MODES}, got {mode!r}",
                                combine_mode=mode)
    return mode


def merge_flash_partials(
    m: torch.Tensor,  # (B, Hkv, S, G) f32 — NEG_INF (-1e30) when dead
    l: torch.Tensor,  # (B, Hkv, S, G) f32
    acc: torch.Tensor,  # (B, Hkv, S, G, D) f32, un-normalised
    axes: Sequence[str],
    *,
    combine_mode: Optional[str] = None,
    out_dtype=torch.float32,
) -> torch.Tensor:
    """Merge every rank's flash-decoding partials over the mesh ``axes``
    (the kvp decode path).  ``combine_mode``:

      * ``"kernel"`` — all-gather the partials (one collective of the
        three, packed) and run K2 once at the decode layout over the
        ``n·S`` splits (``combine_partials_kernel``, route "dist"): the
        same reduction as the single-device split-K op;
      * ``"plain"`` — merge the local splits, then an all-reduce max of m
        and one all-reduce sum of ``l·e^(m−m*)`` and ``acc·e^(m−m*)``.

    A rank with no live page holds m = -1e30, l = 0, acc = 0: both modes
    treat it as neutral (its weight e^(−1e30 − m*) is 0, or 1 times l = 0
    when every rank is dead, whose output is 0).  Returns (B, Hkv, G, D)
    in ``out_dtype``."""
    from repro_torch.kernels.paged_attention.paged_attention import (
        combine_partials_kernel)
    mesh = current_mesh()
    n = mesh.prod(tuple(axes)) if mesh is not None and axes else 1
    mode = resolve_combine_mode(combine_mode, n)
    B, Hkv, S, G = m.shape
    D = acc.shape[-1]
    if mode == "kernel":
        k = B * Hkv * S * G
        packed = torch.cat([m.reshape(-1), l.reshape(-1), acc.reshape(-1)])
        allp = all_gather(packed, axes)  # (n, k·(D + 2))

        def splits(t, *tail):  # (n, B, Hkv, S, G, ...) -> (B, Hkv, n·S, ...)
            t = t.reshape(n, B, Hkv, S, G, *tail).movedim(0, 2)
            return t.reshape(B, Hkv, n * S, G, *tail)

        return combine_partials_kernel(
            splits(allp[:, :k]), splits(allp[:, k:2 * k]),
            splits(allp[:, 2 * k:], D), dtype=out_dtype, route="dist")
    m_loc = m.amax(dim=2)  # (B, Hkv, G)
    corr = torch.exp(m - m_loc[:, :, None])
    l_loc = (l * corr).sum(dim=2)
    o_loc = (acc * corr[..., None]).sum(dim=2)  # (B, Hkv, G, D)
    m_g = all_reduce(m_loc, axes, "max")
    c = torch.exp(m_loc - m_g)
    lo = all_reduce(torch.cat([(l_loc * c)[..., None], o_loc * c[..., None]],
                              dim=-1), axes)
    return (lo[..., 1:] / torch.clamp(lo[..., :1], min=1e-30)).to(out_dtype)


# ---------------------------------------------------------------------------
# page stripes
# ---------------------------------------------------------------------------
def local_lens(lens: torch.Tensor, page_size: int, n: int, s: int
               ) -> torch.Tensor:
    """The live tokens of stripe ``s`` of ``n`` for rows of global length
    ``lens``, in local slot order a prefix: ``P·#{L < len//P : L ≡ s (mod
    n)}`` whole pages, plus ``len % P`` when the partial page ``len // P``
    is this stripe's.  int32 (B,)."""
    lens = lens.long()
    full = lens // page_size
    whole = torch.clamp(full - s + n - 1, min=0) // n
    part = torch.where(full % n == s, lens % page_size,
                       torch.zeros_like(lens))
    return (whole * page_size + part).to(torch.int32)


def local_lens_plain(lens: torch.Tensor, page_size: int, n: int, s: int,
                     pages_per_shard: int) -> torch.Tensor:
    """Plain version of ``local_lens``: the count of stripe ``s``'s live
    slots under the JAX ``_partial_decode`` mask, ``pos = (slot // P · n +
    s) · P + slot % P < len``, over ``pages_per_shard`` local pages."""
    return stripe_live(lens, page_size, n, s, pages_per_shard).sum(
        dim=1).to(torch.int32)


def stripe_live(lens: torch.Tensor, page_size: int, n: int, s: int,
                pages_per_shard: int) -> torch.Tensor:
    """(B, pages_per_shard · P) liveness of stripe ``s``'s local slots, as
    the JAX ``_partial_decode`` masks them."""
    slot = torch.arange(pages_per_shard * page_size, device=lens.device)
    pos = (slot // page_size * n + s) * page_size + slot % page_size
    return pos[None, :] < lens.long()[:, None]


# ---------------------------------------------------------------------------
# decode attention / writes by scheme
# ---------------------------------------------------------------------------
def layer_scheme(scheme: str, window: int) -> str:
    """The scheme a layer decodes under the plan's ``scheme``: a windowed
    layer decodes kvp as dp (ring pools are never striped)."""
    return "dp" if window > 0 and scheme == "kvp" else scheme


def kv_axes_of(mesh, batch_axes: Sequence[str]) -> Tuple[str, ...]:
    """The kvp stripe axes: every mesh axis not used for batch."""
    return tuple(a for a in mesh.axis_names if a not in tuple(batch_axes))


def decode_attention_sharded(
    q4: torch.Tensor,  # (B, Hkv, G, hd) — this rank's q, grouped by kv head
    k_pages: torch.Tensor,  # (num_pages, P, Hkv, hd) — this rank's pools
    v_pages: torch.Tensor,
    tables: torch.Tensor,  # (B, 1, pages_per_shard) int32, this rank's
    lens: torch.Tensor,  # (B,) global lengths
    *,
    window: int = 0,
    softcap: float = 0.0,
    scheme: str = "local",  # local | tp | dp | kvp
    batch_axes: Tuple[str, ...] = (),
    impl: str = "kernel",
    kv_scale: float = 0.0,
    pages_per_block: Optional[int] = None,
    num_splits: Optional[int] = None,
    combine_mode: Optional[str] = None,
) -> torch.Tensor:
    """Decode attention of this rank's q over its pools.  Returns (B, Hkv,
    G, hd).  Under ``local``, ``tp`` and ``dp`` the tensors a rank holds
    are the whole problem of its heads, and the single-device op (K1 +
    K2) runs on them; under ``kvp`` K1 runs over this rank's page stripe
    and the partials merge across the stripe axes."""
    mesh = current_mesh()
    b, nk, g, d = q4.shape
    q = q4.reshape(b, nk * g, d)
    t = tables.reshape(b, -1)
    kw = dict(window=window, softcap=softcap, impl=impl, kv_scale=kv_scale,
              pages_per_block=pages_per_block, num_splits=num_splits)
    if mesh is None or scheme != "kvp":
        if scheme not in ("local", "tp", "dp", "kvp"):
            raise EngineConfigError(f"unknown decode scheme {scheme!r}",
                                    scheme=scheme)
        o = core_attn.decode_attention(q, k_pages, v_pages, t, lens, **kw)
        return o.reshape(b, nk, g, d)
    kv_axes = kv_axes_of(mesh, batch_axes)
    o = core_attn.decode_attention(
        q, k_pages, v_pages, t, lens, kv_axes=kv_axes,
        page_stride=mesh.prod(kv_axes), page_offset=mesh.flat_index(kv_axes),
        combine_mode=combine_mode, **kw)
    return o.reshape(b, nk, g, d)


def write_prefill_sharded(k_pages_l: torch.Tensor, v_pages_l: torch.Tensor,
                          tables: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, lens: torch.Tensor, *,
                          window: int = 0) -> None:
    """Scatter a prompt's K/V into this rank's pools, in place: each rank
    writes the rows and heads it holds (no collective).  The decode
    layout differs under kvp (pages striped); ``shard_decode_state`` is
    that phase boundary."""
    kvcache.write_layer_prefill(k_pages_l, v_pages_l, tables.reshape(
        tables.shape[0], -1), k, v, lens, window=window)


def write_decode_sharded(
    k_pages: torch.Tensor,  # (num_pages, P, Hkv, hd) — this rank's pools
    v_pages: torch.Tensor,
    tables: torch.Tensor,  # (B, 1, pages_per_shard) — this rank's
    positions: torch.Tensor,  # (B,) 0-based position of the incoming token
    k_new: torch.Tensor,  # (B, Hkv, hd)
    v_new: torch.Tensor,
    *,
    window: int = 0,
    scheme: str = "local",
    batch_axes: Tuple[str, ...] = (),
) -> None:
    """Scatter one new token per sequence into this rank's pools, in
    place.  Under kvp only the stripe that owns the token's page, logical
    page ``pos // P`` with ``pos // P mod n == s``, commits it, at local
    slot ``pos // P // n``."""
    mesh = current_mesh()
    if mesh is None or scheme != "kvp":
        kvcache.write_layer_decode(k_pages, v_pages, tables, positions,
                                   k_new, v_new, window=window)
        return
    if window > 0:
        raise UnsupportedFeature("kvp stripes no windowed ring pools "
                                 "(windowed layers decode under dp)")
    kv_axes = kv_axes_of(mesh, batch_axes)
    n, s = mesh.prod(kv_axes), mesh.flat_index(kv_axes)
    P = k_pages.shape[1]
    logical = positions.long() // P
    t = tables.reshape(tables.shape[0], -1).long()
    slot = logical // n
    mine = (logical % n == s) & (slot < t.shape[1])
    phys = torch.gather(t, 1, torch.clamp(slot, max=t.shape[1] - 1)[:, None]
                        )[:, 0]
    phys = torch.where(mine, phys, torch.full_like(phys, -1))
    off = positions.long() % P
    kvcache._scatter_tokens(k_pages, phys, off, k_new)
    kvcache._scatter_tokens(v_pages, phys, off, v_new)


def dropped_batch_axes(plan) -> Tuple[str, ...]:
    """The mesh axes that a prefill of ``plan.run``'s batch on
    ``plan.mesh`` cuts the rows over and ``plan`` does not
    (``sharding.batch_axes_for`` less ``plan.batch_axes``): () unless
    ``plan`` is weight-stationary (its batch axes ())."""
    return tuple(a for a in batch_axes_for(plan.run.global_batch, plan.mesh)
                 if a not in plan.batch_axes)


def _gather_rows(pos, tables, kp, vp, rec, axes):
    """Every rank's rows over the mesh ``axes`` (rank-major, the rows'
    order under ``launch.steps.shard_batch``): ``pos``, the tables with
    source rank i's page ids offset by i times its pool's pages (-1
    stays -1), the pools joined along their pages and each leaf of the
    recurrent state ``rec`` (None without one) along its rows (dim 1)."""
    n_pages = kp.shape[1]
    pos = all_gather_dim(pos, axes, 0)
    t = all_gather(tables, axes).long()  # (n, B_l, 1, pps)
    off = torch.arange(t.shape[0], device=t.device).reshape(-1, 1, 1, 1)
    t = torch.where(t >= 0, t + off * n_pages, t)
    tables = t.reshape(-1, *t.shape[2:]).to(torch.int32)
    if rec is not None:
        rec = {code: {k: all_gather_dim(v, axes, 1) for k, v in leaves.items()}
               for code, leaves in rec.items()}
    return (pos, tables, all_gather_dim(kp, axes, 1),
            all_gather_dim(vp, axes, 1), rec)


def _rec_channels(rec: Dict, plan) -> Dict:
    """The recurrent state ``rec`` (``{"R": {"h": (n_R, B, w), "conv":
    (n_R, B, cw - 1, w)}}``) with the channels of ``plan``'s layout: the
    rank's ``w/m`` over "model" under ``TPLayout.state`` (cut here from a
    state of every channel), else every channel; a copy.  Other blocks'
    state (``M``, ``S``) raises ``UnsupportedFeature``; channels that are
    neither the whole nor the plan's share raise ``EngineConfigError``."""
    from repro_torch.distributed.sharding import shard_tensor
    if set(rec) - {"R"}:
        raise UnsupportedFeature(
            f"shard_decode_state: the recurrent state of "
            f"{sorted(set(rec) - {'R'})} layers is not distributed")
    mesh, cfg = plan.mesh, plan.run.model
    w = cfg.lru_width or cfg.d_model
    m = mesh.size("model") if plan.layout.state else 1
    out = {}
    for k, v in rec["R"].items():
        if v.shape[-1] == w // m:
            out[k] = v.clone()
        elif v.shape[-1] == w:
            spec = (None,) * (v.dim() - 1) + ("model",)
            out[k] = shard_tensor(v, spec, mesh) if m > 1 else v.clone()
        else:
            raise EngineConfigError(
                f"shard_decode_state: the recurrent state holds "
                f"{v.shape[-1]} channels, the plan's ranks {w // m}",
                channels=v.shape[-1])
    return {"R": out}


def shard_decode_state(state: Dict, plan) -> Dict:
    """The phase boundary of the decode schemes (the port's counterpart of
    ``decode_state_shardings`` applied to a filled state): map the state
    this rank filled under ``plan``'s layout — its batch rows
    (``launch.steps.build_prefill_step``, or every row when the plan has
    no batch axes): ``pos`` (B_l,), pools (L, N, P, Hkv, D) and tables
    (B_l, 1, pps), the pools of the rank's kv heads
    (``plan.layout.kv_heads``: its share under ``tp``, whose prefill wrote
    only those), and with ``R`` layers the recurrent state ``rec``
    (``{"R": {"h": (n_R, B_l, w'), "conv": (n_R, B_l, cw - 1, w')}}``) —
    to its decode layout:

      * ``kvp``: the pages of the rank's stripe, logical page ``j·n + s``
        at local slot j, gathered into a new pool with tables (B_l, 1,
        ceil(pps / n)) of local ids (-1 stays -1);
      * ``tp``/``dp``: the rows' pages as they are;
      * ``rec``: each row's state, as ``pos`` keeps its row, and the
        channels of the plan's layout (``TPLayout.state``: the rank's
        ``w/m`` over "model", cut here from a state of every channel;
        else every channel).

    A state filled under a prefill plan whose rows are cut over more
    batch axes than ``plan``'s (a weight-stationary decode plan has
    none) is first gathered over the axes ``plan`` drops
    (``dropped_batch_axes``): ``pos``, the tables, the pools, each
    source rank's page ids offset by the pages of the ranks before it,
    and the recurrent state's rows, in the same order.  A state of
    another batch than that, pools of another head count or a recurrent
    state of other channels raise ``EngineConfigError``; the
    cross-attention K/V (``cross_k``/``cross_v``) and the state of ``M``
    and ``S`` layers are not distributed yet and raise
    ``UnsupportedFeature``."""
    mesh = plan.mesh
    extra = set(state) - {"pos", "k_pages", "v_pages", "tables", "rec"}
    if extra:
        raise UnsupportedFeature(f"shard_decode_state: state entries "
                                 f"{sorted(extra)} are not distributed")
    rec = state.get("rec")
    if rec is not None:
        rec = _rec_channels(rec, plan)
    kp, vp = state["k_pages"], state["v_pages"]
    if kp.shape[3] != plan.layout.kv_heads:
        raise EngineConfigError(
            f"shard_decode_state: the pools hold {kp.shape[3]} kv heads, "
            f"the plan's ranks {plan.layout.kv_heads} (fill the state "
            "from init_decode_state(run, plan=plan))",
            kv_heads=kp.shape[3])
    pos, tables = state["pos"], state["tables"]
    nb = mesh.prod(plan.batch_axes) if plan.batch_axes else 1
    dropped = dropped_batch_axes(plan)
    if pos.shape[0] * nb != plan.run.global_batch and dropped and (
            pos.shape[0] * nb * mesh.prod(dropped) == plan.run.global_batch):
        with use_mesh(mesh):
            pos, tables, kp, vp, rec = _gather_rows(pos, tables, kp, vp, rec,
                                                    dropped)
    if pos.shape[0] * nb != plan.run.global_batch:
        raise EngineConfigError(
            f"shard_decode_state: the state holds {pos.shape[0]} rows, the "
            f"rank's share of the plan's batch is "
            f"{plan.run.global_batch // nb} (prefill each rank's rows: "
            "launch.steps.build_prefill_step)", rows=pos.shape[0])
    t = tables.reshape(pos.shape[0], -1).long()
    n, s = 1, 0
    if plan.scheme == "kvp":
        n, s = mesh.prod(plan.kv_axes), mesh.flat_index(plan.kv_axes)
    pps = -(-t.shape[1] // n)
    keep = torch.full((t.shape[0], pps), -1, dtype=torch.long,
                      device=t.device)
    cols = torch.arange(s, t.shape[1], n, device=t.device)
    keep[:, :len(cols)] = t[:, cols]
    live = keep >= 0
    phys = keep[live]  # the pages this rank keeps, row-major
    new = torch.full_like(keep, -1)
    new[live] = torch.arange(len(phys), device=t.device)
    out = {"pos": pos.clone(),
           "k_pages": kp[:, phys].contiguous(),
           "v_pages": vp[:, phys].contiguous(),
           "tables": new.to(torch.int32)[:, None, :].contiguous()}
    if rec is not None:
        out["rec"] = rec
    return out
