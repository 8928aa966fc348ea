"""Decode-time attention (port of ``paddle_tpu/kernels/decode_attention.py``).

- :func:`masked_multihead_attention`: single-token GQA decode over a dense
  ``[B, C, Hk, D]`` cache; :func:`paged_decode_attention`: the same over
  serving-layout paged pools ``[NB, Hk, bs, D]`` through a block table.  On
  CUDA tensors both launch ``csrc/decode_attention.cu`` (one kernel for the
  four Pallas decode kernels); on CPU tensors they run the plain versions
  :func:`_decode_reference` / :func:`_paged_pool_reference`.
- :func:`cached_attention_reference` (prefill against a dense cache) and
  :func:`paged_chunk_attention` (chunked / prefix-hit prefill) are plain
  PyTorch on every device, as their JAX originals are plain XLA.
- The scatters ``write_paged_*`` update the pools IN PLACE (the JAX versions
  return new arrays that XLA updates in place under donation); they return
  the same tensors for call-site symmetry.

Pool convention (``serving.Engine``): block 0 is the trash block for
inactive slots and bucket padding; it may hold anything, NaN included.

Registered in :mod:`.registry` under the JAX registry's names: the dense
wrapper as ``decode_mmha`` and ``decode_mmha_fused``, the paged one as
``paged_decode`` and ``paged_decode_fused`` (one CUDA kernel pair serves
both names of each TPU pair), and the torch ops ``paged_chunk_attention``
and ``write_paged_chunk`` with no kernel (certified kernel-free).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..analysis.kernel_lint import BlockUse, KernelSpec, ScratchUse, cuda_semantics, itemsize
from ..framework.dispatch import tls
from . import _build, export_ops, registry

__all__ = ["cached_attention_reference", "masked_multihead_attention",
           "paged_decode_attention", "paged_chunk_attention",
           "write_paged_token", "write_paged_chunk", "write_paged_prefill"]

NEG_INF = -1e30
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_HEAD_DIMS = (32, 64, 128, 256)
_KERNEL_MAX_REP = _build.GEOMETRY["decode_attention"]["DECODE_MAX_REP"]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def cached_attention_reference(q, k_cache, v_cache, offset: int,
                               sm_scale: Optional[float] = None):
    """Attention of a chunk against the (already updated) dense KV cache.

    q: ``[B, S, H, D]`` at absolute positions ``offset .. offset+S``;
    caches ``[B, C, Hk, D]``.  Row ``i`` sees cache slots ``j <= offset + i``.
    Returns ``[B, S, H, D]``."""
    B, S, h, d = q.shape
    C, hk = k_cache.shape[1], k_cache.shape[2]
    rep = h // hk
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qf = q.to(torch.float32).reshape(B, S, hk, rep, d)
    s = torch.einsum("bsgrd,bcgd->bgrsc", qf, k_cache.to(torch.float32)) * sm_scale
    q_pos = offset + torch.arange(S, device=q.device)
    mask = torch.arange(C, device=q.device)[None, :] <= q_pos[:, None]   # [S, C]
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrsc,bcgd->bsgrd", p, v_cache.to(torch.float32))
    return o.reshape(B, S, h, d).to(q.dtype)


def _decode_reference(q, k_cache, v_cache, lengths, sm_scale: float):
    """Single-step decode with per-sequence lengths. q: [B, 1, H, D]; lengths [B]."""
    B, _, h, d = q.shape
    C, hk = k_cache.shape[1], k_cache.shape[2]
    rep = h // hk
    qf = q.to(torch.float32).reshape(B, 1, hk, rep, d)
    s = torch.einsum("bsgrd,bcgd->bgrsc", qf, k_cache.to(torch.float32)) * sm_scale
    mask = torch.arange(C, device=q.device)[None, :] < lengths[:, None]  # [B, C]
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # the p@v contraction runs over masked positions too (weight 0); V there
    # may be pool trash including NaN, and 0*NaN = NaN — zero it
    vf = torch.where(mask[:, :, None, None], v_cache.to(torch.float32), 0.0)
    o = torch.einsum("bgrsc,bcgd->bsgrd", p, vf)
    return o.reshape(B, 1, h, d).to(q.dtype)


def _gather_pool(pool, block_table):
    """[NB, Hk, bs, D] pool + [B, MAXB] table -> [B, MAXB*bs, Hk, D]."""
    B = block_table.shape[0]
    _, hk, _, d = pool.shape
    return pool[block_table.long()].transpose(2, 3).reshape(B, -1, hk, d)


def _paged_pool_reference(q, k_pool, v_pool, block_table, lengths, sm_scale):
    """Gather-based plain version of paged decode (serving layout).

    q: [B, 1, H, D]; pools [NB, Hk, bs, D]; block_table [B, MAXB] int32;
    lengths [B] int32 (valid tokens INCLUDING the current one)."""
    k = _gather_pool(k_pool, block_table)
    v = _gather_pool(v_pool, block_table)
    out = _decode_reference(q, k, v, lengths, sm_scale)
    # inactive slots (length 0) are all-zero, matching the kernel
    return out * (lengths > 0).to(out.dtype)[:, None, None, None]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _launch(q, k, v, lengths, table, cap: int, maxb: int, paged: bool,
            sm_scale: float) -> torch.Tensor:
    B, S, h, d = q.shape
    hk = k.shape[2] if not paged else k.shape[1]
    if S != 1:
        raise ValueError(f"decode attention kernel takes one query token, got S={S}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode attention kernel takes matching {_KERNEL_DTYPES} "
                        f"q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"decode attention kernel takes D in {_KERNEL_HEAD_DIMS}, got {d}")
    if h % hk != 0 or h // hk > _KERNEL_MAX_REP:
        raise ValueError(f"decode attention kernel takes H/Hk <= {_KERNEL_MAX_REP}, "
                         f"got H={h}, Hk={hk}")
    if v.shape != k.shape:
        raise ValueError(f"k/v shapes differ: {tuple(k.shape)} vs {tuple(v.shape)}")
    tensors = [q, k, v, lengths] + ([table] if paged else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode attention kernel: all tensors must be on one device")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("decode attention kernel needs contiguous caches")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode attention kernel needs 16-byte aligned caches "
                         "(TMA tensor maps and 16-byte copies read them)")
    q = q.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    table_ptr = None
    if paged:
        table = table.to(torch.int32).contiguous()
        table_ptr = table.data_ptr()
    out = torch.empty_like(q)
    lib = _build.load("decode_attention")
    capacity = cap * maxb if paged else cap
    nsplit = -(-capacity // lib.decode_attention_split_keys())
    ws = torch.empty(B * hk * nsplit * (h // hk) * (d + 2), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            table_ptr, ws.data_ptr(), out.data_ptr(), B, h, hk, d, cap, maxb,
            k.shape[0], int(paged), nsplit, float(sm_scale), _build.dtype_code(q.dtype), stream)
    _build.check(lib, err, "decode_attention")
    return out


def _lengths_vector(lengths, B: int, device) -> torch.Tensor:
    if isinstance(lengths, int):
        # an op, not a tensor made from host data: torch.export traces it
        return torch.full((B,), lengths, dtype=torch.int32, device=device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=device)
    if lengths.ndim == 0:
        lengths = lengths.expand(B)
    return lengths


def masked_multihead_attention(q, k_cache, v_cache, lengths,
                               sm_scale: Optional[float] = None):
    """Single-token decode attention over a dense KV cache.

    q: ``[B, 1, H, D]``; caches ``[B, C, Hk, D]``; ``lengths`` ``[B]`` int32
    or a scalar (valid cache slots per sequence, INCLUDING the current
    token, which must already be in the cache).  Under
    ``export_ops.export_trace`` the call is the custom op
    ``paddle_tpu_torch::masked_multihead_attention``."""
    registry.ensure_admitted("decode_mmha", q.device, q.dtype)
    registry.ensure_admitted("decode_mmha_fused", q.device, q.dtype)
    B, S, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    lengths = _lengths_vector(lengths, B, q.device)
    if tls.exporting:
        return export_ops.masked_multihead_attention_op(q, k_cache, v_cache, lengths,
                                                        float(sm_scale))
    if q.device.type == "cpu":
        return _decode_reference(q, k_cache, v_cache, lengths, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"masked_multihead_attention: unsupported device {q.device}")
    out = _launch(q, k_cache, v_cache, lengths, None, cap=k_cache.shape[1],
                  maxb=0, paged=False, sm_scale=sm_scale)
    masked_multihead_attention.launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_table, lengths,
                           sm_scale: Optional[float] = None):
    """Decode attention over serving-layout paged pools.

    q: ``[B, 1, H, D]``; pools ``[NB, Hk, bs, D]``; ``block_table``
    ``[B, MAXB]`` int32; ``lengths`` ``[B]`` int32 (0 = inactive slot, whose
    output is all-zero).  The kernel reads only live blocks."""
    registry.ensure_admitted("paged_decode", q.device, q.dtype)
    registry.ensure_admitted("paged_decode_fused", q.device, q.dtype)
    B, S, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return _paged_pool_reference(q, k_pool, v_pool, block_table, lengths, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device {q.device}")
    bs = k_pool.shape[2]
    if bs % 16 != 0:
        raise ValueError(f"paged decode kernel needs block_size % 16 == 0, got {bs}")
    out = _launch(q, k_pool, v_pool, lengths, block_table, cap=bs,
                  maxb=block_table.shape[1], paged=True, sm_scale=sm_scale)
    paged_decode_attention.launches += 1
    return out


masked_multihead_attention.launches = 0
paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# paged scatters and chunk attention (plain PyTorch on every device)
# ---------------------------------------------------------------------------

def write_paged_token(k_pool, v_pool, block_table, lengths, k_new, v_new):
    """Append one token's K/V per sequence into the pools, in place.

    k_new/v_new: ``[B, 1, Hk, D]``.  Target: block ``table[b, lengths[b]//bs]``
    slot ``lengths[b] % bs``.  Inactive slots (length 0, table row pointing at
    the trash block) harmlessly write there."""
    bs = k_pool.shape[2]
    lengths = lengths.long()
    phys = torch.gather(block_table.long(), 1, (lengths // bs)[:, None])[:, 0]
    slot = lengths % bs
    k_pool[phys, :, slot] = k_new[:, 0].to(k_pool.dtype)
    v_pool[phys, :, slot] = v_new[:, 0].to(v_pool.dtype)
    return k_pool, v_pool


def paged_chunk_attention(q, k_pool, v_pool, block_table, ctx_lengths,
                          sm_scale: Optional[float] = None):
    """Chunk attention over paged pools (chunked / prefix-hit prefill).

    q: ``[B, S, H, D]`` at absolute positions ``ctx_lengths[b] ..
    ctx_lengths[b]+S-1``; the chunk's own K/V must already be in the pools
    (:func:`write_paged_chunk`).  Chunk token ``j`` attends cache positions
    ``<= ctx_lengths[b] + j``."""
    _, hk, _, d = k_pool.shape
    B, S, h, _ = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    rep = h // hk
    k = _gather_pool(k_pool, block_table)
    v = _gather_pool(v_pool, block_table)
    C = k.shape[1]
    dev = q.device
    qf = q.to(torch.float32).reshape(B, S, hk, rep, d)
    s = torch.einsum("bsgrd,bcgd->bgrsc", qf, k.to(torch.float32)) * sm_scale
    ctx = ctx_lengths.long()
    q_pos = ctx[:, None] + torch.arange(S, device=dev)[None, :]                # [B, S]
    mask = torch.arange(C, device=dev)[None, None, :] <= q_pos[:, :, None]     # [B, S, C]
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # zero V past every row's reach (ctx+S): pool trash, possibly NaN
    valid = torch.arange(C, device=dev)[None, :] < (ctx + S)[:, None]          # [B, C]
    vf = torch.where(valid[:, :, None, None], v.to(torch.float32), 0.0)
    o = torch.einsum("bgrsc,bcgd->bsgrd", p, vf)
    return o.reshape(B, S, h, d).to(q.dtype)


def write_paged_chunk(k_pool, v_pool, block_table, ctx_lengths, k_chunk, v_chunk):
    """Scatter an S-token chunk's K/V into the pools in place, starting at
    position ``ctx_lengths[b]`` per sequence.

    PRECONDITION: every ``ctx_lengths[b]`` is block-aligned and ``S`` is a
    multiple of ``bs`` (table entries past a sequence's real blocks are
    0 = trash, so the pad tail lands there).  ``k_chunk/v_chunk``:
    ``[B, S, Hk, D]``."""
    bs = k_pool.shape[2]
    B, S = k_chunk.shape[0], k_chunk.shape[1]
    start_block = ctx_lengths.long() // bs                                     # [B]
    tbl = block_table.long()
    for i in range(S // bs):
        phys = torch.gather(tbl, 1, (start_block + i)[:, None])[:, 0]          # [B]
        kb = k_chunk[:, i * bs:(i + 1) * bs].transpose(1, 2)                   # [B,Hk,bs,D]
        vb = v_chunk[:, i * bs:(i + 1) * bs].transpose(1, 2)
        k_pool[phys] = kb.to(k_pool.dtype)
        v_pool[phys] = vb.to(v_pool.dtype)
    return k_pool, v_pool


def write_paged_prefill(k_pool, v_pool, blocks, k_seq, v_seq):
    """Scatter a prefilled sequence's K/V into its blocks, in place.

    ``blocks``: ``[n_blocks]`` physical ids; ``k_seq/v_seq``:
    ``[n_blocks*bs, Hk, D]`` (bucket-padded; the tail past the true length
    is never attended)."""
    _, hk, bs, d = k_pool.shape
    n = blocks.shape[0]
    ks = k_seq.reshape(n, bs, hk, d).transpose(1, 2)                           # [n, Hk, bs, D]
    vs = v_seq.reshape(n, bs, hk, d).transpose(1, 2)
    idx = blocks.long()
    k_pool[idx] = ks.to(k_pool.dtype)
    v_pool[idx] = vs.to(v_pool.dtype)
    return k_pool, v_pool


# ---------------------------------------------------------------------------
# kernel-registry entries (verified by analysis.kernel_lint; see registry.py)
# ---------------------------------------------------------------------------

def resident_tiles(D: int, dtype) -> int:
    """32-key tiles of K and V a CTA of pass 1 holds at once: the whole split
    where they fit ``DECODE_RESIDENT_BYTES``, else 4, 2 or 1
    (``Smem::kResident`` in the source)."""
    geo = _build.GEOMETRY["decode_attention"]
    tile_kv = 2 * geo["DECODE_TILE"] * D * itemsize(dtype)
    for r in (geo["DECODE_SPLIT_KEYS"] // geo["DECODE_TILE"], 4, 2):
        if r * tile_kv <= geo["DECODE_RESIDENT_BYTES"]:
            return r
    return 1


def kernel_specs(B: int, H: int, Hk: int, D: int, cap: int, dtype, paged: bool = False,
                 maxb: int = 0, num_blocks: int = 0):
    """The two launches of ``csrc/decode_attention.cu``: the split-K pass,
    grid (Hk, B, nsplit), whose CTA walks its split in rounds of
    :func:`resident_tiles` tiles (the loop axis; one round up to D 128 in
    bf16), writing the workspace, then the combine pass, grid (Hk, B, rep),
    a thread an output element, reading it.  Paged pools are addressed
    through the block table by the kernel itself."""
    geo = _build.GEOMETRY["decode_attention"]
    split, tile, max_rep = geo["DECODE_SPLIT_KEYS"], geo["DECODE_TILE"], geo["DECODE_MAX_REP"]
    capacity = cap * maxb if paged else cap
    nsplit = -(-capacity // split)
    res = resident_tiles(D, dtype)
    rounds = -(-(split // tile) // res)
    rep = H // Hk
    width = rep * (D + 2)
    f32, i32 = torch.float32, torch.int32
    lengths = BlockUse((B,), i32, (1,), lambda *pt: (pt[1],), name="lengths")
    q = BlockUse((B, H, D), dtype, (1, rep, D), lambda g, b, s, c: (b, g, 0), name="q")
    if paged:
        kv = [BlockUse((num_blocks, Hk, cap, D), dtype, memory_space="any", name=n)
              for n in ("k_pool", "v_pool")]
        kv.append(BlockUse((B, maxb), i32, (1, maxb), lambda g, b, s, c: (b, 0),
                           name="block_table"))
    else:
        keys = res * tile
        last = -(-cap // keys) - 1      # rounds past the capacity are never visited
        kv = [BlockUse((B, cap, Hk, D), dtype, (1, keys, 1, D),
                       lambda g, b, s, c: (b, min(s * rounds + c, last), g, 0),
                       name=n, masked=True) for n in ("k_cache", "v_cache")]
    ws = BlockUse((B, Hk, nsplit, width), f32, (1, 1, 1, width),
                  lambda g, b, s, c: (b, g, s, 0), name="workspace")
    partial = KernelSpec(
        "decode_partial_kernel", grid=(Hk, B, nsplit, rounds),
        inputs=[q, *kv, lengths], outputs=[ws],
        scratch=[ScratchUse((1024,), torch.uint8),                # alignment slack (TMA swizzle)
                 ScratchUse((res, 2, tile, D), dtype),            # K, V tiles of a round
                 ScratchUse((max_rep, D), dtype),                 # the query rows
                 ScratchUse((max_rep, res * tile), f32),          # scores, then probabilities
                 ScratchUse((max_rep, res), f32),                 # each (row, tile)'s max
                 ScratchUse((max_rep, res), f32),                 # ... sum
                 ScratchUse((max_rep, res), f32),                 # ... rescale factor
                 ScratchUse((max_rep,), f32),                     # running max
                 ScratchUse((max_rep,), f32),                     # running sum
                 ScratchUse((2, res), torch.int64),               # a tile's mbarriers (TMA, cp.async)
                 ScratchUse((max_rep, D), f32, "registers")],     # the p @ V accumulators
        dimension_semantics=cuda_semantics(3, 1),
        # the online softmax state is carried over the CTA's own rounds only
        carried_scratch=[(7, frozenset({3})), (8, frozenset({3})), (10, frozenset({3}))],
        cuda=("decode_attention", 0, _build.dtype_code(dtype), D, int(paged)))
    combine = KernelSpec(
        "decode_combine_kernel", grid=(Hk, B, rep),
        inputs=[BlockUse((B, Hk, nsplit, width), f32, (1, 1, nsplit, width),
                         lambda g, b, r: (b, g, 0, 0), name="workspace"), lengths],
        outputs=[BlockUse((B, H, D), dtype, (1, 1, D), lambda g, b, r: (b, g * rep + r, 0),
                          name="out")],
        dimension_semantics=cuda_semantics(3),
        cuda=("decode_attention", 1, _build.dtype_code(dtype), D, int(paged)))
    return [partial, combine]


def _randn(g, shape, device, dtype=torch.float32):
    return torch.randn(shape, generator=g).to(dtype).to(device)


# the `serve` phase of chip_smoke.py: its first eight requests' lengths at
# their last decode step (prompt plus new tokens)
SERVE_LENGTHS = (251, 247, 506, 350, 548, 445, 558, 466)


# (B, H, Hk, D, C, lengths): the JAX registry's example, at lengths where
# a split of 129-255 live keys ends off a 32-key tile (fp32 at D 128 holds
# half a split at once: its last tile comes by cp.async in a later round);
# at `serve` the table's dense shape, Llama-3-8B's heads over a 2048-slot
# cache, ragged
_DENSE_SHAPES = {"": (2, 8, 2, 128, 512, [200, 500]),
                 "serve": (8, 32, 8, 128, 2048, [1, 37, 128, 129, 500, 1024, 2047, 2048])}


def _dense_example(dtype="float32"):
    name, _, at = dtype.partition("@")
    B, h, hk, d, C, lens = _DENSE_SHAPES[at]
    dt = getattr(torch, name)

    def args(device):
        g = torch.Generator().manual_seed(0)
        return (_randn(g, (B, 1, h, d), device, dt), _randn(g, (B, C, hk, d), device, dt),
                _randn(g, (B, C, hk, d), device, dt),
                torch.tensor(lens, dtype=torch.int32, device=device))

    scale = 1.0 / math.sqrt(d)
    return (kernel_specs(B, h, hk, d, C, dt),
            lambda q, k, v, ln: masked_multihead_attention(q, k, v, ln, scale),
            lambda q, k, v, ln: _decode_reference(q, k, v, ln, scale), args)


def _paged_tables(B, maxb, device):
    """Block tables over distinct live blocks (block 0, the trash block,
    never referenced)."""
    return (torch.arange(B * maxb, dtype=torch.int32) + 1).reshape(B, maxb).to(device)


# (B, H, Hk, D, num_blocks, bs, maxb): the JAX registry's example (at the
# dense example's lengths); at `serve` the Engine's pool and table width
# (buckets up to 512 tokens: 8 blocks of 128) at Llama-3-8B's heads, over
# the `serve` phase's lengths
_PAGED_SHAPES = {"": (2, 8, 2, 128, 16, 128, 4), "serve": (8, 32, 8, 128, 512, 128, 8)}


def _paged_example(dtype="float32"):
    name, _, at = dtype.partition("@")
    B, h, hk, d, nb, bs, maxb = _PAGED_SHAPES[at]
    dt = getattr(torch, name)
    lens = torch.tensor(SERVE_LENGTHS if at else _DENSE_SHAPES[""][-1], dtype=torch.int32)

    def args(device):
        g = torch.Generator().manual_seed(0)
        return (_randn(g, (B, 1, h, d), device, dt), _randn(g, (nb, hk, bs, d), device, dt),
                _randn(g, (nb, hk, bs, d), device, dt), _paged_tables(B, maxb, device),
                lens.to(device))

    scale = 1.0 / math.sqrt(d)
    return (kernel_specs(B, h, hk, d, bs, dt, paged=True, maxb=maxb, num_blocks=nb),
            lambda q, k, v, bt, ln: paged_decode_attention(q, k, v, bt, ln, scale),
            lambda q, k, v, bt, ln: _paged_pool_reference(q, k, v, bt, ln, scale), args)


# fp32: the plain version sums in another order; bf16: two bf16 ulps
_BF16_TOL = (1e-3, 1.6e-2, None)
_DECODE = dict(dtypes=("float32", "bfloat16", "bfloat16@serve"),
               tol={"float32": (2e-5, 2e-5, None), "bfloat16": _BF16_TOL,
                    "bfloat16@serve": _BF16_TOL})
registry.register("decode_mmha", _dense_example, presets=("decode", "serve"),
                  description="per-(batch, kv-head) dense decode attention", **_DECODE)
registry.register("decode_mmha_fused", _dense_example, presets=("decode", "serve"),
                  description="fused-heads dense decode: ANY-space cache + manual "
                              "double-buffered DMA", **_DECODE)
registry.register("paged_decode", _paged_example, presets=("serve",),
                  description="paged decode attention, per-(batch, kv-head) programs",
                  **_DECODE)
registry.register("paged_decode_fused", _paged_example, presets=("serve",),
                  description="fused-heads paged decode: one DMA per live block", **_DECODE)


def _chunk_example():
    B, S, h, hk, d, nb, bs, maxb = 2, 128, 8, 2, 128, 16, 128, 4

    def args(device):
        g = torch.Generator().manual_seed(0)
        return (_randn(g, (B, S, h, d), device), _randn(g, (nb, hk, bs, d), device),
                _randn(g, (nb, hk, bs, d), device), _paged_tables(B, maxb, device),
                torch.tensor([bs, 0], dtype=torch.int32, device=device))

    return [], paged_chunk_attention, paged_chunk_attention, args


def _write_chunk_example():
    B, S, hk, d, nb, bs, maxb = 2, 128, 2, 128, 16, 128, 4

    def args(device):
        g = torch.Generator().manual_seed(0)
        return (_randn(g, (nb, hk, bs, d), device), _randn(g, (nb, hk, bs, d), device),
                _paged_tables(B, maxb, device),
                torch.tensor([bs, 0], dtype=torch.int32, device=device),
                _randn(g, (B, S, hk, d), device), _randn(g, (B, S, hk, d), device))

    return [], write_paged_chunk, write_paged_chunk, args


registry.register("paged_chunk_attention", _chunk_example, presets=("serve",),
                  description="chunked-prefill attention over paged pools (XLA gather "
                              "path; certified to contain no unverified pallas_call)")
registry.register("write_paged_chunk", _write_chunk_example, presets=("serve",),
                  description="paged-pool chunk scatter (XLA path; certified "
                              "pallas_call-free)")
