"""Flash attention, forward and backward (port of
``paddle_tpu/kernels/flash_attention.py``).

Layout ``[batch, seq, heads, head_dim]`` as in the JAX package; K/V may have
fewer heads than Q (grouped-query attention), indexed natively: query head
``h`` reads kv-head ``h // (H // Hk)``, as ``jnp.repeat`` lays them out.

- :func:`flash_attention` is the public entry, differentiable through
  :class:`_FlashAttention` (a ``torch.autograd.Function``): the forward
  keeps ``(q, k, v, o, lse)`` and the backward computes ``delta = sum(do *
  o)`` and runs the dK/dV and dQ passes.
- :func:`flash_attention_fwd` and :func:`flash_attention_bwd` are the kernel
  wrappers.  On a CUDA tensor each launches the hand-written kernels of
  ``csrc/flash_attention.cu`` (the counterparts of ``_flash_fwd_impl`` /
  ``_flash_fwd_stream`` and ``_flash_bwd_impl`` / ``_flash_bwd_stream``) or
  raises; on a CPU tensor each runs its plain version,
  :func:`_flash_fwd_reference` or :func:`_flash_bwd_reference`, the same
  recompute-from-lse math in fp32.  ``flash_attention_bwd.launches`` counts
  one per backward call, which launches both passes (in fp32 the dK/dV pass
  and the sum of its dQ shares, once for each :func:`dq_groups` group);
  each wrapper's ``launches_noncausal`` counts its non-causal launches
  apart.
- :func:`_attention_reference` is the numerics oracle (one-shot softmax over
  KV heads already repeated), as in the JAX package.

``lse`` is fp32 ``[B, H, Sq]``; the JAX kernels carry it as ``[B*H, 1, Sq]``
for TPU tiling, the same values.

Registered in :mod:`.registry` as ``flash_fwd_resident`` (non-causal),
``flash_fwd_stream`` (causal: the clamped KV map) and ``flash_bwd_stream``
(both backward passes), the JAX registry's names at its example shape.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ..analysis.kernel_lint import BlockUse, KernelSpec, ScratchUse, cuda_semantics, tabulated
from ..framework.dispatch import shape_inference, tls
from . import _build, export_ops, registry

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd"]

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
_HEAD_DIMS = (32, 64, 128, 256)


def _attention_reference(q, k, v, causal: bool, mask, sm_scale: float):
    """Plain attention over ``[B, S, H, D]`` (KV heads already repeated),
    causal diagonal offset by ``Sk - Sq``; fp32 scores; ``mask`` boolean
    (keep) or additive."""
    qt = q.transpose(1, 2).to(torch.float32)
    kt = k.transpose(1, 2).to(torch.float32)
    vt = v.transpose(1, 2).to(torch.float32)
    scores = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * sm_scale
    sq, sk = scores.shape[-2], scores.shape[-1]
    if causal:
        keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        scores = torch.where(keep, scores, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = torch.where(mask, scores, NEG_INF)
        else:
            scores = scores + mask.to(torch.float32)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vt)
    return out.transpose(1, 2).to(q.dtype)


# ---------------------------------------------------------------------------
# plain versions of the two kernels
# ---------------------------------------------------------------------------

def _scores(q, k, causal: bool, sm_scale: float):
    """fp32 ``[B, H, Sq, Sk]`` scaled scores with the -1e30 causal mask; KV
    heads repeated to the query heads."""
    rep = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).to(torch.float32)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).to(torch.float32)
    s = torch.matmul(qt, kt.transpose(-1, -2)) * sm_scale
    if causal:
        sq, sk = s.shape[-2], s.shape[-1]
        keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        s = torch.where(keep, s, NEG_INF)
    return s


def _blind_rows(sq: int, sk: int, causal: bool) -> int:
    """How many leading query rows see no key: with the causal diagonal
    offset by ``Sk - Sq < 0``, the first ``Sq - Sk``."""
    return max(sq - sk, 0) if causal else 0


def _probs(s, lse, causal: bool):
    """``exp(s - lse)``; a row that sees no key has every score at -1e30,
    they tie, and it weighs each key ``1 / Sk``, as the one-shot softmax of
    :func:`_attention_reference` gives it (``exp(s - lse)`` would give 1:
    ``lse = -1e30 + log(Sk)`` rounds to -1e30 in fp32)."""
    p = torch.exp(s - lse[..., None])
    blind = _blind_rows(s.shape[-2], s.shape[-1], causal)
    if blind:
        p[..., :blind, :] = 1.0 / s.shape[-1]
    return p


def _flash_fwd_reference(q, k, v, causal: bool, sm_scale: float):
    """``(o, lse)``: ``lse = logsumexp(s)`` fp32 ``[B, H, Sq]``, ``o =
    exp(s - lse) @ v`` in q's dtype (a row that sees no key: the mean of
    v)."""
    rep = q.shape[2] // k.shape[2]
    s = _scores(q, k, causal, sm_scale)
    lse = torch.logsumexp(s, dim=-1)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).to(torch.float32)
    o = torch.matmul(_probs(s, lse, causal), vt)
    return o.transpose(1, 2).to(q.dtype), lse


def _flash_bwd_reference(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """``(dq, dk, dv)`` from the saved ``lse``, as ``_flash_bwd_impl``:
    ``p = exp(s - lse)``, ``delta = sum(do * o)``, ``ds = p (dp - delta)
    scale``, all fp32; dK/dV summed over each kv-head's query heads.  A row
    that sees no key weighs each key ``1 / Sk`` and has ``ds = 0``: its
    scores are the constant -1e30, as autograd of the one-shot softmax
    gives it."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    rep = H // Hk
    p = _probs(_scores(q, k, causal, sm_scale), lse, causal)
    qt = q.transpose(1, 2).to(torch.float32)
    kt = k.repeat_interleave(rep, dim=2).transpose(1, 2).to(torch.float32)
    vt = v.repeat_interleave(rep, dim=2).transpose(1, 2).to(torch.float32)
    dot = do.transpose(1, 2).to(torch.float32)
    delta = (dot * o.transpose(1, 2).to(torch.float32)).sum(-1)
    dv = torch.matmul(p.transpose(-1, -2), dot)
    dp = torch.matmul(dot, vt.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * sm_scale
    ds[..., :_blind_rows(Sq, Sk, causal), :] = 0.0
    dq = torch.matmul(ds, kt)
    dk = torch.matmul(ds.transpose(-1, -2), qt)

    def group_sum(x):    # [B, H, Sk, D] -> [B, Sk, Hk, D]
        return x.reshape(B, Hk, rep, Sk, D).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), group_sum(dk).to(k.dtype),
            group_sum(dv).to(v.dtype))


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _aligned_rows(x):
    """``x`` itself when every ``[..., D]`` row starts 16-byte aligned (the
    kernels load rows with 16-byte vectors), else a contiguous copy."""
    size = x.element_size()
    if (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(st * size % 16 == 0 for st in x.stride()[:3])):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q [B, Sq, H, D] and k, v [B, Sk, Hk, D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes one dtype of {_DTYPES}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in {_HEAD_DIMS}, got {D}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")


def dq_groups(Sk: int, D: int) -> Tuple[int, int]:
    """``(slots, groups)`` of the fp32 backward at ``Sk`` keys and head
    dim ``D``: its dK/dV pass writes each k-tile's share of dQ to a slot of
    a workspace of ``slots`` slots, and runs (with the dQ sum after it) once
    for each of ``groups`` groups of up to ``FLASH32_DQ_SLOTS`` k-tiles.  A
    function of the shape alone, as ``launch_bwd_f32`` in
    csrc/flash_attention.cu computes it."""
    n_kt = -(-Sk // _geometry("FLASH32_DKDV_K_ROWS", D))
    cap = _build.GEOMETRY["flash_attention"]["FLASH32_DQ_SLOTS"]
    return min(n_kt, cap), -(-n_kt // cap)


def _strides(*xs):
    vals = [s for x in xs for s in (x.stride(0), x.stride(1), x.stride(2))]
    return (ctypes.c_longlong * len(vals))(*vals)


def flash_attention_fwd(q, k, v, causal: bool, sm_scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [B, Sq, H, D] in q's dtype, lse [B, H, Sq] fp32)``: the CUDA
    kernel for CUDA tensors, :func:`_flash_fwd_reference` for CPU ones (and
    for the meta ones of a recording's shape inference: it moves no data)."""
    registry.ensure_admitted("flash_fwd_resident", q.device, q.dtype)
    registry.ensure_admitted("flash_fwd_stream", q.device, q.dtype)
    if q.device.type != "cuda":
        if q.device.type == "cpu" or shape_inference(q):
            return _flash_fwd_reference(q, k, v, causal, sm_scale)
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    q, k, v = (_aligned_rows(x) for x in (q, k, v))
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            ctypes.addressof(strides), B, H, Hk, Sq, Sk, D, int(bool(causal)),
            float(sm_scale), _build.dtype_code(q.dtype), stream)
    _build.check(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.launches_noncausal += int(not causal)
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool, sm_scale: float):
    """``(dq, dk, dv)`` in the dtypes of q, k, v: the CUDA dK/dV and dQ
    passes for CUDA tensors (``delta = sum(do * o)`` is a torch op ahead of
    them), :func:`_flash_bwd_reference` for CPU ones."""
    registry.ensure_admitted("flash_bwd_stream", q.device, q.dtype)
    if q.device.type == "cpu":
        return _flash_bwd_reference(q, k, v, o, lse, do, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v)
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: do {tuple(do.shape)} {do.dtype} and o "
                         f"{tuple(o.shape)} must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be fp32 [{B}, {H}, {Sq}]")
    q, k, v, do = (_aligned_rows(x) for x in (q, k, v, do))
    lse = lse.contiguous()
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1).transpose(1, 2).contiguous()
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Sk, Hk, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Sk, Hk, D), dtype=q.dtype, device=q.device)
    slots = dq_groups(Sk, D)[0] if q.dtype == torch.float32 else 0
    work = torch.empty((slots, B, Sq, H, D), dtype=torch.float32, device=q.device)
    strides = _strides(q, k, v, do)
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(),
            ctypes.addressof(strides), B, H, Hk, Sq, Sk, D, int(bool(causal)),
            float(sm_scale), _build.dtype_code(q.dtype), stream)
    _build.check(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_noncausal += int(not causal)
    return dq, dk, dv


flash_attention_fwd.launches = flash_attention_fwd.launches_noncausal = 0
flash_attention_bwd.launches = flash_attention_bwd.launches_noncausal = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, mask=None,
                    sm_scale: Optional[float] = None):
    """Memory-efficient attention over ``[B, S, H, D]`` (K/V with ``Hk``
    heads, ``H % Hk == 0``), differentiable.  A ``mask`` is taken only on
    the CPU, through the plain :func:`_attention_reference`; the CUDA
    kernels raise for one.  Under ``export_ops.export_trace`` the call is the
    custom op ``paddle_tpu_torch::flash_attention``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if mask is not None:
        if q.device.type != "cpu":
            raise ValueError("flash_attention: the CUDA kernel takes no mask")
        rep = q.shape[2] // k.shape[2]
        return _attention_reference(q, k.repeat_interleave(rep, dim=2),
                                    v.repeat_interleave(rep, dim=2), causal, mask, sm_scale)
    if tls.exporting:
        return export_ops.flash_attention_op(q, k, v, bool(causal), float(sm_scale))
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))


# ---------------------------------------------------------------------------
# kernel-registry entries (verified by analysis.kernel_lint; see registry.py)
# ---------------------------------------------------------------------------

def _geometry(name: str, D: int) -> int:
    return _build.GEOMETRY["flash_attention"][f"{name}_D{D}"]


def _kv_tiles(q0: int, BQ: int, BK: int, Sq: int, Sk: int, causal: bool) -> int:
    """k-tiles of BK keys a q-tile of BQ rows from q0 visits, as
    ``kv_tiles`` in csrc/flash_attention.cu: up to the causal diagonal, or
    every one when its first row sees no key."""
    n_k = -(-Sk // BK)
    off = Sk - Sq
    if not causal or q0 + off < 0:
        return n_k
    return min((min(q0 + BQ, Sq) - 1 + off) // BK + 1, n_k)


def _smem_tiles(kind: str, D: int, dtype):
    """The shared memory of one kernel, as csrc/flash_attention.cu lays it
    out.  fp32 (CUDA-core kernels; tiles row-major, each row padded by 4
    floats): the forward's Q tile, the K and V tiles of each stage of its
    ring and the P tile; the dK/dV pass's K and V tiles, each stage's Q, dO,
    lse and delta, and the P and dS tiles; the dQ sum none.
    bf16 (tensor-core kernels): the slack that aligns the tiles to 1024
    bytes, the tiles TMA loads once, the two streamed tiles once per stage
    of the ring (swizzled in place), and the mbarriers (the tiles loaded
    once; each stage's two tiles and its release)."""
    f32 = torch.float32
    geo = _build.GEOMETRY["flash_attention"]
    if dtype == torch.float32:
        if kind == "fwd":
            BQ, BK = _geometry("FLASH32_FWD_Q_ROWS", D), _geometry("FLASH32_FWD_K_ROWS", D)
            return ([ScratchUse((BQ, D + 4), f32)]
                    + [ScratchUse((BK, D + 4), f32)] * (2 * geo["FLASH32_STAGES"])
                    + [ScratchUse((BQ, BK + 4), f32)])
        if kind == "dkdv":
            BK, BQ = _geometry("FLASH32_DKDV_K_ROWS", D), _geometry("FLASH32_DKDV_Q_ROWS", D)
            step = [ScratchUse((BQ, D + 4), f32)] * 2 + [ScratchUse((BQ,), f32)] * 2
            return ([ScratchUse((BK, D + 4), f32)] * 2 + step * geo["FLASH32_STAGES"]
                    + [ScratchUse((BQ, BK + 4), f32)] * 2)
        return []
    bf = torch.bfloat16
    if kind == "fwd":       # Q once; K and V streamed
        once, streamed, stages = ((_geometry("FLASH_FWD_Q_ROWS", D),),
                                  _geometry("FLASH_FWD_K_ROWS", D), geo["FLASH_FWD_STAGES"])
    elif kind == "dkdv":    # K and V once; Q and dO streamed
        once, streamed, stages = ((_geometry("FLASH_DKDV_K_ROWS", D),) * 2,
                                  _geometry("FLASH_DKDV_Q_ROWS", D), geo["FLASH_BWD_STAGES"])
    else:                   # Q and dO once; K and V streamed
        once, streamed, stages = ((_geometry("FLASH_DQ_Q_ROWS", D),) * 2,
                                  _geometry("FLASH_DQ_K_ROWS", D), geo["FLASH_BWD_STAGES"])
    return ([ScratchUse((1024,), torch.uint8)]                  # alignment slack
            + [ScratchUse((rows, D), bf) for rows in once]
            + [ScratchUse((streamed, D), bf)] * (2 * stages)    # the ring's two tiles a stage
            + [ScratchUse((1 + 3 * stages,), torch.int64)])     # the mbarriers


def kernel_specs(B: int, Sq: int, Sk: int, H: int, Hk: int, D: int, causal: bool, dtype,
                 backward: bool = False):
    """The launches of ``csrc/flash_attention.cu``: the forward, one CTA a
    (batch x head, q-tile) walking the k-tiles of its kv-head; or the dK/dV
    pass, one CTA a (batch x kv-head, k-tile) walking its group's heads and
    the q-tiles from the causal lower bound, and the dQ pass, one CTA a
    (batch x head, q-tile) walking k-tiles.  Under the causal mask a walk
    ends at the diagonal: the map is clamped there (a revisit reads nothing
    new), as the JAX kernels' index map is.  fp32 runs the CUDA-core kernels
    (grid (q-tiles, batch x heads)), bf16 the tensor-core ones (grid
    (batch x heads, q-tiles), the q-tiles with the longest causal walks
    first).  Every tile load is masked past the sequence.

    The fp32 backward's second launch is the dQ sum, not a walk: the dK/dV
    pass writes each (k-tile, q-tile, head)'s share of dQ to a slot of a
    workspace, zeros for the q-tiles a causal walk skips, and
    ``flash_bwd_dq_kernel`` sums the shares slot by slot, 1024 values of dq
    a CTA.  The pair runs once for each :func:`dq_groups` group of k-tiles,
    in k-tile order: a group's dK/dV launch reads and writes its own rows
    of k, v, dk and dv (the view from its first k-tile) and fills a slot a
    k-tile, and every group's sum after the first reads dq and adds to it
    (dq an input aliased to the output).  So the fp32 backward is a list of
    (dK/dV, dQ sum) specs, one pair a group."""
    rep, off = H // Hk, Sk - Sq
    code = _build.dtype_code(dtype)
    f32 = torch.float32
    tc = dtype != f32
    if tc:
        fq, fk = _geometry("FLASH_FWD_Q_ROWS", D), _geometry("FLASH_FWD_K_ROWS", D)
        vk, vq = _geometry("FLASH_DKDV_K_ROWS", D), _geometry("FLASH_DKDV_Q_ROWS", D)
        qq, qk = _geometry("FLASH_DQ_Q_ROWS", D), _geometry("FLASH_DQ_K_ROWS", D)
    else:
        fq, fk = _geometry("FLASH32_FWD_Q_ROWS", D), _geometry("FLASH32_FWD_K_ROWS", D)
        vk, vq = _geometry("FLASH32_DKDV_K_ROWS", D), _geometry("FLASH32_DKDV_Q_ROWS", D)

    def rows(name, S, heads, rows_, at):
        return BlockUse((B, S, heads, D), dtype, (1, rows_, 1, D), at, name=name, masked=True)

    def stats(name, rows_, at):
        return BlockUse((B, H, Sq), f32, (1, 1, rows_), at, name=name, masked=True)

    def walk(BQ, BK, heads_first):
        """A CTA a (q-tile, batch x head) that walks the k-tiles of its
        kv-head: (grid, the q-tile of a grid point, the batch x head, the
        k-tile)."""
        nq, nk = -(-Sq // BQ), -(-Sk // BK)
        last = [_kv_tiles(i * BQ, BQ, BK, Sq, Sk, causal) - 1 for i in range(nq)]

        def at(x, y, j):
            i, bh = (nq - 1 - y, x) if heads_first else (x, y)
            return i, bh, max(min(j, last[i]), 0)
        grid = (B * H, nq, nk) if heads_first else (nq, B * H, nk)
        return grid, at

    def q_rows(name, BQ, at):
        def m(*pt):
            i, bh, _ = at(*pt)
            return (bh // H, i, bh % H, 0)
        return rows(name, Sq, H, BQ, m)

    def kv_rows(name, BK, at):
        def m(*pt):
            _, bh, j = at(*pt)
            return (bh // H, j, bh % H // rep, 0)
        return rows(name, Sk, Hk, BK, m)

    def q_stats(name, BQ, at):
        def m(*pt):
            i, bh, _ = at(*pt)
            return (bh // H, bh % H, i)
        return stats(name, BQ, m)

    acc = ScratchUse((fq, D), f32, "registers")
    if not backward:
        grid, at = walk(fq, fk, tc)
        tiles = _smem_tiles("fwd", D, dtype)
        stat = ScratchUse((fq,), f32, "registers")
        return [KernelSpec(
            "flash_fwd_tc_kernel" if tc else "flash_fwd_kernel", grid=grid,
            inputs=[q_rows("q", fq, at), kv_rows("k", fk, at), kv_rows("v", fk, at)],
            outputs=[q_rows("o", fq, at), q_stats("lse", fq, at)],
            scratch=tiles + [stat, stat, acc],
            dimension_semantics=cuda_semantics(2, 1),
            # the online softmax (max, sum, accumulators) is carried over the k-tile walk
            carried_scratch=[(n, frozenset({2})) for n in range(len(tiles), len(tiles) + 3)],
            cuda=("flash_attention", 0, code, D, 0))]

    # dK/dV: a CTA a (k-tile, batch x kv-head), looping over the group's
    # heads and the q-tiles from the causal lower bound (every q-tile when
    # rows that see no key, Sq > Sk, see every key)
    nkv, nqv = -(-Sk // vk), -(-Sq // vq)
    dkdv_tiles = _smem_tiles("dkdv", D, dtype)
    kv_acc = ScratchUse((vk, D), f32, "registers")

    def lo(j):
        return max(j * vk - off, 0) // vq if causal and off >= 0 else 0

    def dkdv_spec(kt0, n_kt):
        """The dK/dV launch over k-tiles kt0 .. kt0 + n_kt - 1: its k, v, dk
        and dv are the rows of those k-tiles, its workspace n_kt slots."""
        kv_len = min(Sk, (kt0 + n_kt) * vk) - kt0 * vk

        def kv_at(*pt):
            j, bg = (pt[1], pt[0]) if tc else (pt[0], pt[1])
            r, qt = pt[2], pt[3]
            return j, bg, r, max(qt, lo(kt0 + j))

        def kv_tile(name):
            def m(*pt):
                j, bg, _, _ = kv_at(*pt)
                return (bg // Hk, j, bg % Hk, 0)
            return rows(name, kv_len, Hk, vk, m)

        def q_tile(name):
            def m(*pt):
                _, bg, r, qt = kv_at(*pt)
                return (bg // Hk, qt, bg % Hk * rep + r, 0)
            return rows(name, Sq, H, vq, m)

        def q_stat(name):
            def m(*pt):
                _, bg, r, qt = kv_at(*pt)
                return (bg // Hk, bg % Hk * rep + r, qt)
            return stats(name, vq, m)

        outputs = [kv_tile("dk"), kv_tile("dv")]
        if not tc:  # fp32: each (k-tile, q-tile, head)'s share of dQ, skipped ones zero
            def share(j, bg, r, qt):
                return (j, bg // Hk, qt, bg % Hk * rep + r, 0)
            outputs.append(BlockUse((n_kt, B, Sq, H, D), f32, (1, 1, vq, 1, D), share,
                                    name="dq_shares", masked=True))
        return KernelSpec(
            "flash_bwd_dkdv_tc_kernel" if tc else "flash_bwd_dkdv_kernel",
            grid=(B * Hk, n_kt, rep, nqv) if tc else (n_kt, B * Hk, rep, nqv),
            inputs=[kv_tile("k"), kv_tile("v"), q_tile("q"), q_tile("do"), q_stat("lse"),
                    q_stat("delta")],
            outputs=outputs,
            scratch=dkdv_tiles + [kv_acc, kv_acc],
            dimension_semantics=cuda_semantics(2, 2),
            # dK and dV sum over the group's heads and the q-tiles, inside the CTA
            carried_scratch=[(len(dkdv_tiles), frozenset({2, 3})),
                             (len(dkdv_tiles) + 1, frozenset({2, 3}))],
            cuda=("flash_attention", 1, code, D, 0))

    if not tc:
        n, per = B * Sq * H * D, 4 * _build.GEOMETRY["flash_attention"]["FLASH32_DQ_THREADS"]
        slots, groups = dq_groups(Sk, D)
        specs = []
        for g in range(groups):
            kt0 = g * slots
            n_kt = min(slots, nkv - kt0)
            dq_block = BlockUse((n,), dtype, (per,), lambda x: (x,), name="dq", masked=True)
            inputs = [BlockUse((n_kt, n), f32, (n_kt, per), lambda x: (0, x),
                               name="dq_shares", masked=True)]
            if g:   # a later group adds its shares to dq
                inputs.append(BlockUse((n,), dtype, (per,), lambda x: (x,), name="dq",
                                       masked=True))
            specs += [dkdv_spec(kt0, n_kt), KernelSpec(
                "flash_bwd_dq_kernel", grid=(-(-n // per),), inputs=inputs,
                outputs=[dq_block], aliases={1: 0} if g else {},
                dimension_semantics=cuda_semantics(1),
                cuda=("flash_attention", 2, code, D, 0))]
        return specs
    dkdv = dkdv_spec(0, nkv)

    grid, at = walk(qq, qk, tc)
    tiles = _smem_tiles("dq", D, dtype)
    dq = KernelSpec(
        "flash_bwd_dq_tc_kernel" if tc else "flash_bwd_dq_kernel", grid=grid,
        inputs=[q_rows("q", qq, at), q_rows("do", qq, at), kv_rows("k", qk, at),
                kv_rows("v", qk, at), q_stats("lse", qq, at), q_stats("delta", qq, at)],
        outputs=[q_rows("dq", qq, at)],
        scratch=tiles + [ScratchUse((qq, D), f32, "registers")],
        dimension_semantics=cuda_semantics(2, 1),
        carried_scratch=[(len(tiles), frozenset({2}))],
        cuda=("flash_attention", 2, code, D, 0))
    return [dkdv, dq]


# the JAX registry's example: BH 2, S 256, D 128 fp32 (here B 1, H = Hk = 2),
# also in bf16, which runs the tensor-core kernels; the causal entries also
# at `base`'s shape in bf16 ("bfloat16@base": B 3, S 2048, H 16 over Hk 8),
# the launches the training path makes, so the card's leg checks them at a
# production shape; the non-causal forward and the backward also at
# ERNIE-base's attention in fp32 ("float32@ernie": S 512, 12 heads of 64,
# non-causal, as `ernie_train` launches it, with B cut from 32 to 1 so the
# dynamic leg stays a small part of the kernel_gate phase); the fp32
# backward also at 9 k-tiles of 128 keys ("float32@groups": S 1152, D 64,
# causal), one more than a dQ workspace holds, so both legs check a second
# group of launches, the one that adds to dq (B, S, H, Hk, D)
_EXAMPLES = {"": (1, 256, 2, 2, 128), "base": (3, 2048, 16, 8, 128),
             "ernie": (1, 512, 12, 12, 64), "groups": (1, 1152, 2, 2, 64)}
_NONCAUSAL_EXAMPLES = ("ernie",)    # the backward's examples are causal but these
_EX_DTYPES = ("float32", "bfloat16")
_RESIDENT_DTYPES = _EX_DTYPES + ("float32@ernie",)
_STREAM_DTYPES = _EX_DTYPES + ("bfloat16@base",)
# the output against the plain version: fp32 sums in another order, bf16 two
# bf16 ulps; lse fp32 in both; the gradients' atol scaled by their largest
# |value| (at least 1)
_FWD_TOL = {"float32": ((2e-5, 2e-5, None), (1e-5, 1e-5, None)),
            "bfloat16": ((1e-3, 1.6e-2, None), (1e-5, 1e-5, None))}
_BWD_TOL = {"float32": (2e-5, 2e-5, 1.0), "bfloat16": (1e-3, 1.6e-2, 1.0)}
for _tol in (_FWD_TOL, _BWD_TOL):
    _tol["bfloat16@base"] = _tol["bfloat16"]
    _tol["float32@ernie"] = _tol["float32@groups"] = _tol["float32"]


def _example(dtype: str):
    """(torch dtype, (B, S, H, Hk, D)) of an example key."""
    name, _, shape = dtype.partition("@")
    return getattr(torch, name), _EXAMPLES[shape]


def _example_qkv(device, shape, seed=0, dtype=torch.float32):
    B, S, H, Hk, D = shape
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(B, S, h, D, generator=g).to(dtype).to(device) for h in (H, Hk, Hk))


def _fwd_example(causal):
    def build(dtype="float32"):
        dt, shape = _example(dtype)
        B, S, H, Hk, D = shape
        scale = 1.0 / math.sqrt(D)
        return (tabulated(kernel_specs(B, S, S, H, Hk, D, causal, dt)),
                lambda q, k, v: flash_attention_fwd(q, k, v, causal, scale),
                lambda q, k, v: _flash_fwd_reference(q, k, v, causal, scale),
                lambda device: _example_qkv(device, shape, dtype=dt))
    return build


def _bwd_example(dtype="float32"):
    dt, shape = _example(dtype)
    B, S, H, Hk, D = shape
    scale = 1.0 / math.sqrt(D)
    causal = dtype.partition("@")[2] not in _NONCAUSAL_EXAMPLES

    def args(device):
        q, k, v = _example_qkv(device, shape, dtype=dt)
        o, lse = _flash_fwd_reference(q, k, v, causal, scale)
        do = _example_qkv(device, shape, seed=1, dtype=dt)[0]
        return q, k, v, o, lse, do

    return (tabulated(kernel_specs(B, S, S, H, Hk, D, causal, dt, backward=True)),
            lambda q, k, v, o, lse, do: flash_attention_bwd(q, k, v, o, lse, do, causal, scale),
            lambda q, k, v, o, lse, do: _flash_bwd_reference(q, k, v, o, lse, do, causal,
                                                             scale),
            args)


_FLASH_PRESETS = ("tiny", "small", "base", "longctx", "moe", "ocr")
registry.register("flash_fwd_resident", _fwd_example(False), presets=_FLASH_PRESETS,
                  description="flash attention forward, full-KV residency", tol=_FWD_TOL,
                  dtypes=_RESIDENT_DTYPES)
registry.register("flash_fwd_stream", _fwd_example(True), presets=_FLASH_PRESETS,
                  description="streaming flash forward: causal KV paging + "
                              "online-softmax VMEM carry", tol=_FWD_TOL, dtypes=_STREAM_DTYPES)
registry.register("flash_bwd_stream", _bwd_example, presets=_FLASH_PRESETS,
                  description="streaming flash backward (dk/dv + dq passes)", tol=_BWD_TOL,
                  dtypes=_STREAM_DTYPES + ("float32@ernie", "float32@groups"))
