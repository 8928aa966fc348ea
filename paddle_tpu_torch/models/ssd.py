"""SSD (state-space duality) decoder family (port of ``paddle_tpu/models/ssd.py``).

Each mixer layer is a linear recurrence whose training path is the chunked
scan (``kernels/ssd_scan``: the CUDA kernel on the card, its plain version on
the CPU) and whose decode path carries a fixed-size per-layer state, so
per-token cost and cache bytes stay constant in context length.  Same
configuration, same parameter names (``ssd.layers.0.mixer.in_proj``, ...),
same ``[in, out]`` weight layout as the JAX package.

Decode state per mixer layer and sequence (all fp32):

    S   [nh, N, P]   inter-chunk state at the last chunk boundary
    xb  [nh, L, P]   \
    bb  [nh, L, N]    | zero-initialized intra-chunk buffers holding the
    cb  [nh, L, N]    | partial current chunk (rows past the in-chunk
    lab [nh, L]      /  offset stay exactly zero)

A decode step writes the token's row into the buffers, recomputes the
current chunk's matmul form (O(L (L + N) P) a token, constant in T), takes
the token's row and folds the chunk into S when it fills; zero rows are
exact no-ops in the chunk form.  The prefill path (the plain chunk loop of
``kernels/ssd_scan.ssd_scan_states``, keeping its boundary states) and the
decode step run in plain PyTorch, as the JAX package runs them in XLA
outside the Pallas kernel.  Unlike the JAX package's, the port's decode
logits are held to the full forward within fp32 rounding, not bitwise.

Hybrid stacks: ``config.layer_types`` mixes ``"ssd"`` mixer blocks with
``"attention"`` blocks, the port's ``LlamaDecoderLayer`` with rope buffers;
a sequence's cache then holds paged (serving) or dense (``generate``) KV for
the attention layers and constant-size states for the SSD layers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device, make_generator, to_dtype
from ..kernels import rope as rope_mod
from ..kernels.ssd_scan import ssd_chunk_outputs, ssd_chunk_state, ssd_scan, ssd_scan_states
from .llama import LlamaConfig, LlamaDecoderLayer, LlamaForCausalLM, LlamaRMSNorm, _param

__all__ = [
    "SSDConfig", "SSDModel", "SSDForCausalLM", "ssd_cache_spec",
    "ssd_tiny_config", "ssd_tiny_hybrid_config", "ssd_8b_config",
]


@dataclass
class SSDConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008   # hybrid attention blocks' MLP width
    num_hidden_layers: int = 32
    num_heads: int = 32
    state_size: int = 64             # N: recurrent state rows per head
    chunk_size: int = 64             # L: the duality chunk (and decode buffer)
    num_key_value_heads: Optional[int] = None  # hybrid attention blocks
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    dtype: str = "float32"
    param_dtype: Optional[str] = None
    # per-layer kinds ("ssd" | "attention"); None -> all ssd
    layer_types: Optional[Tuple[str, ...]] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    # attention-config aliases: the serving tier's plan arithmetic and the
    # hybrid blocks address heads through the Llama field names
    @property
    def num_attention_heads(self) -> int:
        return self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_key_value_heads or self.num_heads

    @property
    def pdtype(self) -> str:
        return self.param_dtype or self.dtype

    @property
    def types(self) -> Tuple[str, ...]:
        if self.layer_types is None:
            return ("ssd",) * self.num_hidden_layers
        if len(self.layer_types) != self.num_hidden_layers:
            raise ValueError(
                f"layer_types has {len(self.layer_types)} entries for "
                f"{self.num_hidden_layers} layers")
        bad = set(self.layer_types) - {"ssd", "attention"}
        if bad:
            raise ValueError(f"unknown layer types {sorted(bad)}")
        return tuple(self.layer_types)

    def attn_config(self) -> LlamaConfig:
        """The Llama-block config the hybrid attention layers reuse."""
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_attention_heads=self.num_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            initializer_range=self.initializer_range, dtype=self.dtype,
            param_dtype=self.param_dtype)


def ssd_tiny_config(**overrides) -> SSDConfig:
    """CPU-smoke scale."""
    cfg = dict(vocab_size=512, hidden_size=128, intermediate_size=384,
               num_hidden_layers=2, num_heads=4, state_size=16, chunk_size=16,
               num_key_value_heads=2, max_position_embeddings=256)
    cfg.update(overrides)
    return SSDConfig(**cfg)


def ssd_tiny_hybrid_config(**overrides) -> SSDConfig:
    """Tiny hybrid stack: one SSD mixer + one attention block."""
    cfg = dict(layer_types=("ssd", "attention"))
    cfg.update(overrides)
    return ssd_tiny_config(**cfg)


def ssd_8b_config(**overrides) -> SSDConfig:
    """Llama-3-8B-comparable widths: 64 heads of P = 64, state N = 128,
    chunk 128."""
    cfg = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
               num_hidden_layers=32, num_heads=64, state_size=128,
               chunk_size=128, max_position_embeddings=65536,
               dtype="bfloat16")
    cfg.update(overrides)
    return SSDConfig(**cfg)


# ---------------------------------------------------------------------------
# mixer math over plain tensors (shared by the train / prefill / decode paths)
# ---------------------------------------------------------------------------

def ssd_project(hidden, w_in, dt_bias, cfg: SSDConfig, n_valid=None):
    """Fused input projection of the mixer: the gate ``z``, scan input
    ``x``, state projections ``B``/``C`` (fp32, cast after the projection)
    and the log-decay ``la = -softplus(dt + dt_bias) <= 0`` in fp32.

    With ``n_valid``, positions at or past it are zeroed in ``x``/``B``/``C``
    and get ``la = 0``: an exact no-op on the recurrence."""
    nh, P, N = cfg.num_heads, cfg.head_dim, cfg.state_size
    B, S, _ = hidden.shape
    proj = hidden @ w_in.to(hidden.dtype)
    z, xp, bp, cp, dt = torch.split(proj, [nh * P, nh * P, nh * N, nh * N, nh], dim=-1)
    x = xp.reshape(B, S, nh, P).to(torch.float32)
    bm = bp.reshape(B, S, nh, N).to(torch.float32)
    cm = cp.reshape(B, S, nh, N).to(torch.float32)
    v = dt.to(torch.float32) + dt_bias.to(torch.float32)[None, None, :]
    la = -torch.logaddexp(v, torch.zeros_like(v))          # jax.nn.softplus
    if n_valid is not None:
        ok = (torch.arange(S, device=hidden.device) < n_valid)[None, :, None]
        x = torch.where(ok[..., None], x, 0.0)
        bm = torch.where(ok[..., None], bm, 0.0)
        cm = torch.where(ok[..., None], cm, 0.0)
        la = torch.where(ok, la, 0.0)
    return x, bm, cm, la, z


def _to_g(t):
    """[B, S, nh, K] -> [B*nh, S, K] (heads are independent recurrences)."""
    B, S, nh, K = t.shape
    return t.permute(0, 2, 1, 3).reshape(B * nh, S, K)


def _from_g(t, B, nh):
    G, S, K = t.shape
    return t.reshape(B, nh, S, K).permute(0, 2, 1, 3)


def _pad_t(t, Sp):
    S = t.shape[1]
    if S == Sp:
        return t
    pad = [0, 0] * (t.dim() - 2) + [0, Sp - S]
    return F.pad(t, pad)


def _scan_inputs(x, bm, cm, la, L):
    """The projections in the scan's [G, Sp, ...] layout, zero-padded to a
    multiple of the chunk ``L``."""
    Sp = -(-x.shape[1] // L) * L
    return (_to_g(_pad_t(x, Sp)), _to_g(_pad_t(bm, Sp)), _to_g(_pad_t(cm, Sp)),
            _to_g(_pad_t(la, Sp)[..., None])[..., 0])


def _finish(y, x, z, d, w_out, hidden_dtype, B, S, cfg):
    """Skip + gate + output projection, one expression for train, prefill
    and decode."""
    nh, P = cfg.num_heads, cfg.head_dim
    y = y + d.to(torch.float32)[None, None, :, None] * x
    y = y.reshape(B, S, nh * P).to(hidden_dtype)
    y = y * F.silu(z)
    return y @ w_out.to(hidden_dtype)


def ssd_mixer_fn(hidden, w_in, dt_bias, d, w_out, cfg: SSDConfig, n_valid=None):
    """Full-sequence mixer (training / no-cache forward) through the chunked
    scan: the kernel on a CUDA tensor, the plain version on a CPU one."""
    B, S, _ = hidden.shape
    x, bm, cm, la, z = ssd_project(hidden, w_in, dt_bias, cfg, n_valid)
    yg, _s = ssd_scan(*_scan_inputs(x, bm, cm, la, cfg.chunk_size), chunk=cfg.chunk_size)
    y = _from_g(yg, B, cfg.num_heads)[:, :S]
    return _finish(y, x, z, d, w_out, hidden.dtype, B, S, cfg)


def ssd_mixer_prefill_fn(hidden, w_in, dt_bias, d, w_out, cfg: SSDConfig, n_valid: int):
    """Prefill with decode-state capture (the JAX package's
    ``_scan_capture``): outputs for every position plus the decode cache
    after ``n_valid`` tokens: the boundary state at the last full chunk and
    the partial chunk's rows as zero-padded buffers."""
    B, S, _ = hidden.shape
    nh, P, N, L = cfg.num_heads, cfg.head_dim, cfg.state_size, cfg.chunk_size
    n_valid = int(n_valid)
    x, bm, cm, la, z = ssd_project(hidden, w_in, dt_bias, cfg, n_valid)
    xg, bg, cg, lg = _scan_inputs(x, bm, cm, la, L)
    yg, states = ssd_scan_states(xg, bg, cg, lg, L)
    nc_v = n_valid // L
    s_b = states[nc_v]
    # partial-chunk buffers: rows [nc_v*L, nc_v*L + L) of the zero-extended
    # projections: exactly zero past n_valid, empty when n_valid is aligned
    start = nc_v * L

    def rows(t):
        ext = F.pad(t, [0, 0] * (t.dim() - 2) + [0, L])
        return ext[:, start:start + L]

    state = {"s": s_b.reshape(B, nh, N, P),
             "xb": rows(xg).reshape(B, nh, L, P),
             "bb": rows(bg).reshape(B, nh, L, N),
             "cb": rows(cg).reshape(B, nh, L, N),
             "lab": rows(lg[..., None])[..., 0].reshape(B, nh, L)}
    y = _from_g(yg, B, nh)[:, :S]
    return _finish(y, x, z, d, w_out, hidden.dtype, B, S, cfg), state


def ssd_decode_step(state, xt, bt, ct, lt, j, active, L: int):
    """One decode token against the fixed-size state, batched over the
    ``G = B * nh`` recurrences: write the token's projections at in-chunk
    row ``j``, recompute the chunk's matmul form, take row ``j``, and fold
    the chunk into ``S`` when it fills.

    ``state``: the per-layer dict, batched [B, nh, ...]; ``xt``/``bt``/
    ``ct``/``lt``: this token's projections [B, nh, ...]; ``j``: [B]
    in-chunk offsets (context length % L); ``active``: [B] bool, inactive
    slots keep every array unchanged."""
    B, nh, N, P = state["s"].shape
    G = B * nh
    dev = xt.device
    s = state["s"].reshape(G, N, P)
    bufs = {k: state[k].reshape((G, L) + state[k].shape[3:]) for k in ("xb", "bb", "cb", "lab")}
    rows = torch.arange(G, device=dev)
    jg = j.to(device=dev, dtype=torch.long).repeat_interleave(nh)
    ag = active.to(dev).repeat_interleave(nh)
    new = {}
    for k, t in zip(("xb", "bb", "cb", "lab"), (xt, bt, ct, lt)):
        new[k] = bufs[k].clone()
        new[k][rows, jg] = t.reshape((G,) + t.shape[2:])
    y_all = ssd_chunk_outputs(s, new["xb"], new["bb"], new["cb"], new["lab"])
    yj = y_all[rows, jg]
    fold = jg == (L - 1)
    s2 = torch.where(fold[:, None, None], ssd_chunk_state(s, new["xb"], new["bb"], new["lab"]), s)

    def keep(new_v, old_v, folded):
        shape = (G,) + (1,) * (old_v.dim() - 1)
        if folded:
            new_v = torch.where(fold.reshape(shape), 0.0, new_v)
        return torch.where(ag.reshape(shape), new_v, old_v)

    new_state = {"s": keep(s2, s, False).reshape(B, nh, N, P)}
    for k in ("xb", "bb", "cb", "lab"):
        new_state[k] = keep(new[k], bufs[k], True).reshape(state[k].shape)
    return yj.reshape(B, nh, P), new_state


def ssd_mixer_decode_fn(hidden, w_in, dt_bias, d, w_out, cfg: SSDConfig, state, j, active):
    """Single-token mixer over the recurrent state (decode path)."""
    B, S, _ = hidden.shape
    x, bm, cm, la, z = ssd_project(hidden, w_in, dt_bias, cfg)
    y, new_state = ssd_decode_step(state, x[:, 0], bm[:, 0], cm[:, 0], la[:, 0], j, active,
                                   cfg.chunk_size)
    out = _finish(y[:, None], x, z, d, w_out, hidden.dtype, B, S, cfg)
    return out, new_state


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class SSDMixer(nn.Module):
    """The selective state-space mixer (z | x | B | C | dt fused in_proj)."""

    def __init__(self, config: SSDConfig, device, gen):
        super().__init__()
        self.config = config
        nh, P, N = config.num_heads, config.head_dim, config.state_size
        std = config.initializer_range
        self.in_proj = _param([config.hidden_size, 2 * nh * P + 2 * nh * N + nh], config,
                              device, gen, std)
        # dt_bias -3 puts the initial per-token decay near exp(-softplus(-3))
        # ~ 0.95: long enough memory for the recurrence to be non-trivial
        self.dt_bias = nn.Parameter(torch.full((nh,), -3.0, dtype=torch.float32, device=device))
        self.d_skip = nn.Parameter(torch.ones(nh, dtype=torch.float32, device=device))
        self.out_proj = _param([nh * P, config.hidden_size], config, device, gen, std)

    def forward(self, x, state=None, n_valid=None, j=None, active=None):
        """The mixer's output; with ``state`` also the new decode state: a
        prefill for more than one token, a decode step for one."""
        cfg = self.config
        args = (x, self.in_proj, self.dt_bias, self.d_skip, self.out_proj, cfg)
        if state is None:
            return ssd_mixer_fn(*args, n_valid)
        if x.shape[1] > 1:
            return ssd_mixer_prefill_fn(*args, x.shape[1] if n_valid is None else n_valid)
        return ssd_mixer_decode_fn(*args, state, j, active)

    def init_state(self, batch_size: int):
        cfg = self.config
        nh, P, N, L = cfg.num_heads, cfg.head_dim, cfg.state_size, cfg.chunk_size
        dev = self.in_proj.device

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        return {"s": z(batch_size, nh, N, P), "xb": z(batch_size, nh, L, P),
                "bb": z(batch_size, nh, L, N), "cb": z(batch_size, nh, L, N),
                "lab": z(batch_size, nh, L)}


class SSDBlock(nn.Module):
    """Pre-norm mixer block (no separate MLP: the mixer's gate is the
    nonlinearity)."""

    def __init__(self, config: SSDConfig, acfg: LlamaConfig, device, gen):
        super().__init__()
        self.norm = LlamaRMSNorm(acfg, device, gen)
        self.mixer = SSDMixer(config, device, gen)

    def forward(self, x, state=None, n_valid=None, j=None, active=None):
        out = self.mixer(self.norm(x), state=state, n_valid=n_valid, j=j, active=active)
        if state is not None:
            h, new_state = out
            return x + h, new_state
        return x + out


class SSDModel(nn.Module):
    def __init__(self, config: SSDConfig, device, gen):
        super().__init__()
        self.config = config
        acfg = config.attn_config()
        self._acfg = acfg
        self.embed_tokens = _param([config.vocab_size, config.hidden_size], config, device,
                                   gen, config.initializer_range)
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(acfg, device, gen) if kind == "attention"
            else SSDBlock(config, acfg, device, gen)
            for kind in config.types])
        self.norm = LlamaRMSNorm(acfg, device, gen)
        if "attention" in config.types:
            cos, sin = rope_mod.rope_freqs(acfg.head_dim, config.max_position_embeddings,
                                           config.rope_theta, device=device)
            self.register_buffer("rope_cos", cos, persistent=False)
            self.register_buffer("rope_sin", sin, persistent=False)
        else:
            self.rope_cos = self.rope_sin = None

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.device

    def _ssd_layers(self):
        return [layer for layer, kind in zip(self.layers, self.config.types) if kind == "ssd"]

    # -- caches -------------------------------------------------------------

    def init_cache(self, batch_size: int, max_len: int, dtype=None):
        """Dense generation cache: per-ssd-layer state dicts plus dense
        ``(k, v)`` pairs for the hybrid attention layers; only the attention
        share grows with ``max_len`` (rounded up to a multiple of 128)."""
        max_len = (max_len + 127) // 128 * 128
        dt = to_dtype(dtype if dtype is not None else self.config.dtype)
        acfg = self._acfg
        shape = (batch_size, max_len, acfg.kv_heads, acfg.head_dim)
        n_attn = self.config.types.count("attention")
        kv = [(torch.zeros(shape, dtype=dt, device=self.device),
               torch.zeros(shape, dtype=dt, device=self.device)) for _ in range(n_attn)]
        return {"ssd": self.init_recurrent_slots(batch_size), "kv": kv, "offset": 0}

    def init_paged_pools(self, num_blocks: int, block_size: int = 128, dtype=None):
        """Paged KV pools ``[NB, Hk, bs, D]`` for the hybrid attention layers
        only (two empty lists for a pure SSD stack)."""
        acfg = self._acfg
        dt = to_dtype(dtype if dtype is not None else self.config.dtype)
        shape = (num_blocks, acfg.kv_heads, block_size, acfg.head_dim)
        n_attn = self.config.types.count("attention")

        def pools():
            return [torch.zeros(shape, dtype=dt, device=self.device) for _ in range(n_attn)]

        return pools(), pools()

    def init_recurrent_slots(self, max_batch: int):
        """One zero decode-state dict per SSD layer, ``max_batch`` rows wide
        (the serving slots' state)."""
        return tuple(layer.mixer.init_state(max_batch) for layer in self._ssd_layers())

    # -- forward ------------------------------------------------------------

    def forward(self, input_ids, position_ids=None, cache=None):
        """Final hidden states; with ``cache`` also the new cache.  A cache
        with ``block_table`` is the serving decode (one token a row, slots
        with ``lengths == 0`` inactive); otherwise the dense cache of
        ``generate``: a prefill from offset 0 (``n_valid`` may mask a padded
        tail) or a decode step."""
        cfg = self.config
        x = F.embedding(input_ids.long(), self.embed_tokens)
        if cfg.pdtype != cfg.dtype:
            x = x.to(to_dtype(cfg.dtype))
        cos, sin = self.rope_cos, self.rope_sin
        kinds = cfg.types
        L = cfg.chunk_size
        if cache is None:
            for layer, kind in zip(self.layers, kinds):
                x = layer(x, cos, sin, position_ids) if kind == "attention" else layer(x)
            return self.norm(x)
        new_ssd, new_kv = [], []
        ssd_states = iter(cache["ssd"])
        if "block_table" in cache:
            tbl, lengths = cache["block_table"], cache["lengths"]
            j = lengths.long() % L
            active = lengths > 0
            pools = iter(zip(cache["k"], cache["v"]))
            for layer, kind in zip(self.layers, kinds):
                if kind == "attention":
                    k_p, v_p = next(pools)
                    x, kv = layer(x, cos, sin, cache=(k_p, v_p, tbl, lengths))
                    new_kv.append(kv)
                else:
                    x, st = layer(x, state=next(ssd_states), j=j, active=active)
                    new_ssd.append(st)
            new_lengths = (lengths + active.to(lengths.dtype)).to(lengths.dtype)
            return self.norm(x), {"ssd": tuple(new_ssd), "k": [kv[0] for kv in new_kv],
                                  "v": [kv[1] for kv in new_kv], "block_table": tbl,
                                  "lengths": new_lengths}
        offset = int(cache["offset"])
        B, S = input_ids.shape
        j = torch.full((B,), offset % L, dtype=torch.long, device=x.device)
        active = torch.ones(B, dtype=torch.bool, device=x.device)
        kv_caches = iter(cache["kv"])
        for layer, kind in zip(self.layers, kinds):
            if kind == "attention":
                k_c, v_c = next(kv_caches)
                x, kv = layer(x, cos, sin, cache=(k_c, v_c, offset))
                new_kv.append(kv)
            else:
                x, st = layer(x, state=next(ssd_states), n_valid=cache.get("n_valid"), j=j,
                              active=active)
                new_ssd.append(st)
        return self.norm(x), {"ssd": tuple(new_ssd), "kv": new_kv, "offset": offset + S}


class SSDForCausalLM(nn.Module):
    """SSD decoder + LM head: the serving tier's second model family.
    ``device`` defaults to ``"cuda"`` (raising without a card); weights are
    drawn from a generator seeded with ``seed``.  The head, ``forward``,
    ``compute_loss`` and ``generate`` are ``LlamaForCausalLM``'s own,
    reached through the ``decoder`` accessor."""

    def __init__(self, config: SSDConfig, device=None, seed: int = 0):
        super().__init__()
        device = default_device(device)
        self.config = config
        self.generator = make_generator(seed, device)
        self.ssd = SSDModel(config, device, self.generator)
        if config.tie_word_embeddings:
            self.lm_head = None
        else:
            self.lm_head = _param([config.hidden_size, config.vocab_size], config, device,
                                  self.generator, config.initializer_range)

    @property
    def decoder(self) -> SSDModel:
        return self.ssd

    @property
    def device(self) -> torch.device:
        return self.ssd.device

    def init_cache(self, batch_size: int, max_len: int, dtype=None):
        return self.ssd.init_cache(batch_size, max_len, dtype)

    def init_paged_pools(self, num_blocks: int, block_size: int = 128, dtype=None):
        return self.ssd.init_paged_pools(num_blocks, block_size, dtype)

    def init_recurrent_slots(self, max_batch: int):
        return self.ssd.init_recurrent_slots(max_batch)

    def cache_spec(self):
        """Per-layer cache kinds plus the byte quantities the serving
        ``CacheBackend`` sizes pools and slot state from."""
        return ssd_cache_spec(self.config)

    head = LlamaForCausalLM.head
    forward = LlamaForCausalLM.forward
    compute_loss = LlamaForCausalLM.compute_loss
    _sample_next = LlamaForCausalLM._sample_next
    _generate_loop = LlamaForCausalLM._generate_loop
    generate = LlamaForCausalLM.generate


def ssd_cache_spec(cfg: SSDConfig) -> dict:
    """``cache_spec`` from the config alone (no parameters needed)."""
    nh, P, N, L = cfg.num_heads, cfg.head_dim, cfg.state_size, cfg.chunk_size
    # one slot's decode state is fp32: S [nh,N,P] + the intra-chunk buffers
    # xb [nh,L,P], bb/cb [nh,L,N], lab [nh,L]
    state_slot = 4 * nh * (N * P + L * P + 2 * L * N + L)
    kinds = cfg.types
    itemsize = to_dtype(cfg.dtype).itemsize
    return {"kinds": kinds,
            "state_bytes_per_slot": state_slot * kinds.count("ssd"),
            "kv_layers": kinds.count("attention"),
            "kv_bytes_per_token_layer": 2 * cfg.kv_heads * cfg.head_dim * itemsize}
