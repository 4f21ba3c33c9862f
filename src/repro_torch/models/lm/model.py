"""LM model zoo: one config dataclass, one builder, five families.

The port of :mod:`repro.models.lm.model`: ``LMConfig`` (``dtype`` is a
``torch.dtype``), the norm and MLP dispatch, the transformer block (its
MLP a routed MoE in the ``moe`` family), and ``build_model`` for the
``dense``, ``moe``, ``zamba``, ``xlstm`` and ``encdec`` families, whose
``Model`` exposes, as the reference's does::

    init(generator, device)                  -> params
    hidden_fn(params, batch)                 -> [B, T, D]
    loss_fn(params, batch)                   -> scalar  (train objective)
    prefill(params, batch, max_len)          -> (last_logits, cache)
    decode_step(params, tok, cache, pos)     -> (logits, cache)
    init_cache(batch, max_len, device)       -> cache
                                                (encdec: batch, max_len,
                                                 enc_len, device)

Params keep the reference's stacked layout (``[L, ...]`` leaves under
``layers``, ``mamba``, ``mlstm``/``slstm`` or ``enc_layers``/
``dec_layers``), so a tree converts leaf by leaf
(:func:`repro_torch.convert.model_params_from_numpy`); where the
reference scans over the stacked axis, the port loops over layers and
indexes each leaf.  The cache is allocated at ``max_len`` by ``prefill``
and ``decode_step`` writes each new row into it in place: the returned
cache is the one passed in, equal to the reference's new one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import is_dtensor
from repro_torch.models.lm import attention as attn
from repro_torch.models.lm import moe as moe_mod
from repro_torch.models.lm import ssm as ssm_mod
from repro_torch.models.lm import xlstm as xlstm_mod
from repro_torch.models.lm.common import (Params, apply_geglu,
                                          apply_gelu_mlp, apply_rope,
                                          apply_swiglu, chunked_softmax_xent,
                                          init_gelu_mlp, init_swiglu,
                                          layer_norm, rms_norm, shard_hint,
                                          sinusoidal_position_at,
                                          sinusoidal_positions,
                                          truncated_normal_init)
from repro_torch.models.lm.moe import MoEConfig
from repro_torch.models.lm.ssm import SSMConfig
from repro_torch.models.lm.xlstm import XLSTMConfig
from repro_torch.tree import leaves as _leaves
from repro_torch.tree import tree_map as _map


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                     # dense | moe | zamba | xlstm | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0         # local attention width (0 = full)
    global_every: int = 0           # gemma3: every k-th layer is global
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    shared_attn_every: int = 0      # zamba
    encoder_layers: int = 0
    n_frontend_tokens: int = 0      # stub prefix length (frames / patches)
    norm: str = "rms"               # rms | layer
    mlp: str = "swiglu"             # swiglu | geglu | gelu
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "none"      # none | dots
    loss_chunk: int = 512
    attn_block_q: int = 512         # blocked-attention q tile (0 = off)
    seq_parallel: bool = False      # Megatron-SP residual (T over model)
    use_flash: bool = False
    use_gla_kernel: bool = False
    sub_quadratic: bool = False     # True => long_500k decode is eligible

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def variant(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# norm / mlp dispatch
# ---------------------------------------------------------------------------

def _resid_hint(cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """Residual-stream sharding: batch over DP; with ``seq_parallel``
    also T over ``model`` (Megatron-SP).  The identity without a mesh in
    scope and on plain tensors (:func:`shard_hint`)."""
    return shard_hint(x, ("pod", "data"),
                      "model" if cfg.seq_parallel else None, None)


def _init_norm(cfg: LMConfig, device=None) -> Params:
    if cfg.norm == "layer":
        return {"w": torch.ones((cfg.d_model,), dtype=cfg.dtype,
                                device=device),
                "b": torch.zeros((cfg.d_model,), dtype=cfg.dtype,
                                 device=device)}
    return {"w": torch.zeros((cfg.d_model,), dtype=cfg.dtype, device=device)}


def _apply_norm(cfg: LMConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layer":
        return layer_norm(x, p["w"], p["b"])
    return rms_norm(x, p["w"])


def _init_mlp(generator: torch.Generator, cfg: LMConfig, device=None
              ) -> Params:
    if cfg.mlp == "gelu":
        return init_gelu_mlp(generator, cfg.d_model, cfg.d_ff, cfg.dtype,
                             device)
    return init_swiglu(generator, cfg.d_model, cfg.d_ff, cfg.dtype, device)


def _apply_mlp(cfg: LMConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp == "gelu":
        return apply_gelu_mlp(p, x)
    if cfg.mlp == "geglu":
        return apply_geglu(p, x)
    return apply_swiglu(p, x)


def _apply_ffn(cfg: LMConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The block's feed-forward: the routed MoE in the ``moe`` family,
    the MLP elsewhere."""
    if cfg.family == "moe":
        return moe_mod.apply_moe(p["moe"], x, cfg.moe)
    return _apply_mlp(cfg, p["mlp"], x)


# ---------------------------------------------------------------------------
# transformer block (dense / moe families; also zamba's shared block and
# whisper's encoder)
# ---------------------------------------------------------------------------

def _init_block(generator: torch.Generator, cfg: LMConfig, device=None
                ) -> Params:
    p = {
        "ln1": _init_norm(cfg, device),
        "attn": attn.init_attention(generator, cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.hd, cfg.dtype,
                                    cfg.qkv_bias, device=device),
        "ln2": _init_norm(cfg, device),
    }
    if cfg.family == "moe":
        p["moe"] = moe_mod.init_moe(generator, cfg.d_model, cfg.moe,
                                    cfg.dtype, device)
    else:
        p["mlp"] = _init_mlp(generator, cfg, device)
    return p


def _apply_block(cfg: LMConfig, p: Params, x: torch.Tensor, window: int,
                 positions: Optional[torch.Tensor] = None,
                 causal: bool = True) -> torch.Tensor:
    x = _resid_hint(cfg, x)
    h = _apply_norm(cfg, p["ln1"], x)
    h = attn.self_attention(
        p["attn"], h, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.hd, causal=causal, rope_theta=cfg.rope_theta,
        window=window, positions=positions, use_flash=cfg.use_flash,
        block_q=cfg.attn_block_q)
    x = x + h
    h = _apply_norm(cfg, p["ln2"], x)
    return x + _apply_ffn(cfg, p, h)


def _group_layout(cfg: LMConfig) -> Tuple[int, int, int]:
    """(n_groups, group_size, n_rest) of the local/global layer pattern.

    group_size == 0 means "uniform window" (no grouping).
    """
    if cfg.sliding_window and cfg.global_every:
        g = cfg.global_every
        return cfg.n_layers // g, g, cfg.n_layers % g
    return 0, 0, cfg.n_layers


def _prefill_block(cfg: LMConfig, p: Params, x: torch.Tensor, cache: Params,
                   window: int) -> Tuple[torch.Tensor, Params]:
    """Transformer block forward that also fills its KV cache: rows
    ``[:T]`` of ``cache`` (``{"k", "v"}``, ``[B, max_len, KV, hd]``) are
    written in place; the rows after them stay as they were (zeros)."""
    B, T, _ = x.shape
    x = _resid_hint(cfg, x)
    h = _apply_norm(cfg, p["ln1"], x)
    q, k, v = attn._qkv_hints(*attn._project_qkv(
        p["attn"], h, h, cfg.n_heads, cfg.n_kv_heads, cfg.hd))
    if cfg.rope_theta > 0:
        pos = torch.arange(T, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if cfg.use_flash:
        from repro_torch.kernels import ops as kops
        o = kops.flash_attention(q, k, v, causal=True, window=window)
    else:
        o = attn.mha(q, k, v, causal=True, window=window,
                     block_q=cfg.attn_block_q)
    x = x + o.reshape(B, T, -1) @ p["attn"]["wo"]
    h = _apply_ffn(cfg, p, _apply_norm(cfg, p["ln2"], x))
    cache["k"][:, :T] = k.to(cache["k"].dtype)
    cache["v"][:, :T] = v.to(cache["v"].dtype)
    return x + h, cache


def _decode_block(cfg: LMConfig, p: Params, x: torch.Tensor, cache: Params,
                  pos: int, window: int) -> Tuple[torch.Tensor, Params]:
    h = _apply_norm(cfg, p["ln1"], x)
    h, ck, cv = attn.decode_self_attention(
        p["attn"], h, cache["k"], cache["v"], pos, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, window=window)
    x = x + h
    h = _apply_ffn(cfg, p, _apply_norm(cfg, p["ln2"], x))
    return x + h, {"k": ck, "v": cv}


def _maybe_remat(cfg: LMConfig, fn: Callable) -> Callable:
    """``fn`` recomputed in the backward (``cfg.remat``) when autograd
    records; the values are the same either way."""
    if not cfg.remat:
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False)
    return wrapped


# ---------------------------------------------------------------------------
# nested-dict trees (walks in repro_torch.tree)
# ---------------------------------------------------------------------------

def _index(tree: Params, i) -> Params:
    """Entry ``i`` of every stacked leaf (views, no copy)."""
    return _map(lambda a: a[i], tree)


def _write(dst: Params, src: Params) -> None:
    """Copy the leaves of ``src`` into those of ``dst`` in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write(dst[k], v)
        else:
            dst[k].copy_(v)


def _stacked(n: int, init_one: Callable[[], Params]) -> Params:
    """``n`` draws of ``init_one()`` stacked leaf by leaf into ``[n, ...]``
    tensors.  Each layer is drawn at its own shape, so its fan-in is the
    reference's under ``vmap`` (never ``n``); the stack and one layer are
    held at a time."""
    first = init_one()
    out = _map(lambda a: a.new_empty((n,) + tuple(a.shape)), first)
    for i in range(n):
        _write(_index(out, i), first if i == 0 else init_one())
    return out


def _split_groups(stacked: Params, n_groups: int, g: int
                  ) -> Tuple[Params, Params, Params]:
    """Split ``[L, ...]`` stacked leaves into (local ``[ng, g-1, ...]``,
    global ``[ng, ...]``, rest ``[n_rest, ...]``), as views: a cache
    written through them is written in the reference's merged ``[ng*g +
    n_rest]`` order, each group's local layers before its global one."""
    def grouped(a):
        return a[:n_groups * g].reshape((n_groups, g) + tuple(a.shape[1:]))

    local = _map(lambda a: grouped(a)[:, :-1], stacked)
    glob = _map(lambda a: grouped(a)[:, -1], stacked)
    rest = _map(lambda a: a[n_groups * g:], stacked)
    return local, glob, rest


def _decoder_layers(cfg: LMConfig, stacked: Params
                    ) -> List[Tuple[Params, int]]:
    """(layer slice of ``stacked``, attention window) of each decoder
    layer, in the order the reference's scans run them: one uniform
    stack, or per group its ``g-1`` local layers then its global one,
    then the rest."""
    ng, g, n_rest = _group_layout(cfg)
    sw = cfg.sliding_window
    if ng == 0:
        return [(_index(stacked, i), sw) for i in range(cfg.n_layers)]
    local, glob, rest = _split_groups(stacked, ng, g)
    out = []
    for gi in range(ng):
        out += [(_index(local, (gi, j)), sw) for j in range(g - 1)]
        out.append((_index(glob, gi), 0))
    return out + [(_index(rest, i), sw) for i in range(n_rest)]


# ---------------------------------------------------------------------------
# Model build — per family
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Model:
    cfg: LMConfig
    init: Callable[..., Params]          # (generator, device=None)
    hidden_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]
    loss_fn: Callable[[Params, Dict[str, torch.Tensor]], torch.Tensor]
    prefill: Callable[..., Tuple[torch.Tensor, Params]]
    decode_step: Callable[..., Tuple[torch.Tensor, Params]]
    init_cache: Callable[..., Params]    # (batch, max_len, device=None)


def build_model(cfg: LMConfig) -> Model:
    if cfg.family in ("dense", "moe"):
        return _build_decoder(cfg)
    if cfg.family == "zamba":
        return _build_zamba(cfg)
    if cfg.family == "xlstm":
        return _build_xlstm(cfg)
    if cfg.family == "encdec":
        return _build_encdec(cfg)
    raise ValueError(f"unknown family {cfg.family}")


# --- shared head/embedding helpers ----------------------------------------

def _init_head(generator: torch.Generator, cfg: LMConfig, device=None
               ) -> Params:
    return {
        "embed": truncated_normal_init(generator, (cfg.vocab, cfg.d_model),
                                       1.0, cfg.dtype, device),
        "final_norm": _init_norm(cfg, device),
        "lm_head": truncated_normal_init(generator, (cfg.d_model, cfg.vocab),
                                         1.0, cfg.dtype, device),
    }


def _embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"]
    if is_dtensor(emb) and is_dtensor(tokens):
        return _embed_on_shards(emb, tokens)
    return emb.index_select(0, tokens.reshape(-1)).reshape(
        tuple(tokens.shape) + (emb.shape[1],))


def _embed_on_shards(emb: torch.Tensor, tokens: torch.Tensor
                     ) -> torch.Tensor:
    """The lookup of DTensor tokens in a DTensor table on each rank's
    local shards (Megatron's vocab-parallel embedding): the table
    gathered but for a vocab split over ``model``, each rank's rows of
    its tokens looked up, those outside its vocab slice zero, the result
    a pending sum over ``model`` (a whole lookup where the vocab is not
    split).  DTensor's own strategy for the lookup's backward pairs
    replicated indices with a row-sharded gradient on torch 2.11
    (``index_add``: "Number of indices ... should be equal to
    tensor.size(dim)")."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = emb.device_mesh
    names = tuple(mesh.mesh_dim_names)
    m = names.index("model") if "model" in names else -1
    vocab = m >= 0 and emb.placements[m] == Shard(0)
    if vocab and tokens.placements[m].is_shard():
        tokens = tokens.redistribute(mesh, tuple(
            Replicate() if i == m else p
            for i, p in enumerate(tokens.placements)))
    tp = tokens.placements
    table = tuple(Shard(0) if vocab and i == m else Replicate()
                  for i in range(len(names)))
    grad = tuple(table[i] if i == m else
                 Partial() if tp[i].is_shard() else Replicate()
                 for i in range(len(names)))
    local = emb.redistribute(mesh, table).to_local(grad_placements=grad)
    ids = tokens.to_local().reshape(-1)
    if vocab:
        rows = local.shape[0]
        ids = ids - mesh.get_local_rank(m) * rows
        inside = (ids >= 0) & (ids < rows)
        out = local.index_select(0, ids.clamp(0, rows - 1)) * \
            inside[:, None].to(local.dtype)
    else:
        out = local.index_select(0, ids)
    out_pl = tuple(p if p.is_shard() else
                   Partial() if vocab and i == m else Replicate()
                   for i, p in enumerate(tp))
    shape = tuple(tokens.shape) + (emb.shape[1],)
    return DTensor.from_local(
        out.reshape(tuple(tokens.to_local().shape) + (emb.shape[1],)), mesh,
        out_pl, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def _prefix_embeds(params: Params, batch: Dict[str, torch.Tensor],
                   cfg: LMConfig) -> torch.Tensor:
    """token embeddings, with optional frontend-stub prefix concatenated."""
    x = _embed_tokens(params, batch["tokens"])
    if "embeds" in batch:
        x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
    return x


def _loss_from_hidden(cfg: LMConfig, params: Params, hidden: torch.Tensor,
                      batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    hidden = _apply_norm(cfg, params["final_norm"], hidden)
    if "embeds" in batch:  # prefix positions carry no LM loss
        hidden = hidden[:, batch["embeds"].shape[1]:]
    return chunked_softmax_xent(hidden, params["lm_head"], batch["targets"],
                                batch.get("mask"), chunk=cfg.loss_chunk)


def _last_logits(cfg: LMConfig, params: Params, x: torch.Tensor
                 ) -> torch.Tensor:
    """f32 logits of the last position; the product in the model dtype,
    then the cast, as the reference orders them."""
    x = _apply_norm(cfg, params["final_norm"], x[:, -1:])
    return (x @ params["lm_head"]).float()[:, 0]


# --- dense / moe decoder -----------------------------------------------------

def _build_decoder(cfg: LMConfig) -> Model:
    def init(generator: torch.Generator, device=None) -> Params:
        dev = generator.device if device is None else torch.device(device)
        p = _init_head(generator, cfg, dev)
        p["layers"] = _stacked(cfg.n_layers,
                               lambda: _init_block(generator, cfg, dev))
        return p

    def hidden_fn(params: Params, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
        x = _prefix_embeds(params, batch, cfg)
        block = _maybe_remat(
            cfg, lambda x, lp, w: _apply_block(cfg, lp, x, w))
        for lp, window in _decoder_layers(cfg, params["layers"]):
            x = block(x, lp, window)
        return x

    def loss_fn(params, batch):
        return _loss_from_hidden(cfg, params, hidden_fn(params, batch),
                                 batch)

    def init_cache(batch: int, max_len: int, device=None) -> Params:
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}

    def prefill(params: Params, batch: Dict[str, torch.Tensor], max_len: int
                ) -> Tuple[torch.Tensor, Params]:
        """Run the full prompt, return (last-position logits, filled cache)."""
        x = _prefix_embeds(params, batch, cfg)
        cache = init_cache(x.shape[0], max_len, x.device)
        for (lp, window), (lc, _) in zip(
                _decoder_layers(cfg, params["layers"]),
                _decoder_layers(cfg, cache)):
            x, _ = _prefill_block(cfg, lp, x, lc, window)
        return _last_logits(cfg, params, x), cache

    def decode_step(params: Params, tok: torch.Tensor, cache: Params,
                    pos: int) -> Tuple[torch.Tensor, Params]:
        x = _embed_tokens(params, tok)          # [B, 1, D]
        for (lp, window), (lc, _) in zip(
                _decoder_layers(cfg, params["layers"]),
                _decoder_layers(cfg, cache)):
            x, _ = _decode_block(cfg, lp, x, lc, pos, window)
        return _last_logits(cfg, params, x), cache

    return Model(cfg, init, hidden_fn, loss_fn, prefill, decode_step,
                 init_cache)


# --- zamba: mamba2 backbone + shared attention block ------------------------

def _build_zamba(cfg: LMConfig) -> Model:
    if cfg.ssm is None or cfg.shared_attn_every <= 0:
        raise ValueError("a zamba config needs ssm and shared_attn_every > 0")
    g = cfg.shared_attn_every
    ng = cfg.n_layers // g                      # groups ending in shared blk
    window = cfg.sliding_window

    def order():
        """("mamba", layer) and ("attn", group) in the reference's order:
        each group's ``g`` Mamba2 layers then the shared block, then the
        ``n_layers - ng*g`` trailing Mamba2 layers."""
        for gi in range(ng):
            yield from (("mamba", i) for i in range(gi * g, (gi + 1) * g))
            yield "attn", gi
        yield from (("mamba", i) for i in range(ng * g, cfg.n_layers))

    def init(generator: torch.Generator, device=None) -> Params:
        dev = generator.device if device is None else torch.device(device)
        p = _init_head(generator, cfg, dev)
        p["mamba"] = _stacked(cfg.n_layers, lambda: {
            "pre": _init_norm(cfg, dev),
            "m": ssm_mod.init_mamba2(generator, cfg.d_model, cfg.ssm,
                                     cfg.dtype, dev)})
        p["shared"] = _init_block(generator, cfg, dev)
        return p

    def hidden_fn(params: Params, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
        x = _embed_tokens(params, batch["tokens"])

        def mamba(x, lp):
            x = _resid_hint(cfg, x)
            h = _apply_norm(cfg, lp["pre"], x)
            return x + ssm_mod.apply_mamba2(lp["m"], h, cfg.ssm,
                                            use_kernel=cfg.use_gla_kernel)
        mamba = _maybe_remat(cfg, mamba)
        shared = _maybe_remat(cfg, lambda x, p: _apply_block(cfg, p, x,
                                                             window))
        for kind, i in order():
            if kind == "mamba":
                x = mamba(x, _index(params["mamba"], i))
            else:
                x = shared(x, params["shared"])
        return x

    def loss_fn(params, batch):
        return _loss_from_hidden(cfg, params, hidden_fn(params, batch),
                                 batch)

    def init_cache(batch: int, max_len: int, device=None) -> Params:
        m = ssm_mod.init_mamba2_cache(batch, cfg.d_model, cfg.ssm, cfg.dtype,
                                      device)
        shape = (ng, batch, max_len, cfg.n_kv_heads, cfg.hd)
        return {
            "mamba": _map(lambda a: a.new_zeros((cfg.n_layers,)
                                                + tuple(a.shape)), m),
            "attn": {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                     "v": torch.zeros(shape, dtype=cfg.dtype, device=device)},
        }

    def prefill(params: Params, batch: Dict[str, torch.Tensor], max_len: int
                ) -> Tuple[torch.Tensor, Params]:
        x = _embed_tokens(params, batch["tokens"])
        cache = init_cache(x.shape[0], max_len, x.device)
        for kind, i in order():
            if kind == "attn":
                x, _ = _prefill_block(cfg, params["shared"], x,
                                      _index(cache["attn"], i), window)
                continue
            lp = _index(params["mamba"], i)
            h = _apply_norm(cfg, lp["pre"], x)
            y, c = ssm_mod.prefill_mamba2(lp["m"], h, cfg.ssm,
                                          use_kernel=cfg.use_gla_kernel)
            _write(_index(cache["mamba"], i), c)
            x = x + y
        return _last_logits(cfg, params, x), cache

    def decode_step(params: Params, tok: torch.Tensor, cache: Params,
                    pos: int) -> Tuple[torch.Tensor, Params]:
        x = _embed_tokens(params, tok)
        for kind, i in order():
            if kind == "attn":
                x, _ = _decode_block(cfg, params["shared"], x,
                                     _index(cache["attn"], i), pos, window)
                continue
            lp = _index(params["mamba"], i)
            lc = _index(cache["mamba"], i)
            h = _apply_norm(cfg, lp["pre"], x)
            y, nc = ssm_mod.decode_mamba2(lp["m"], h, lc, cfg.ssm)
            _write(lc, nc)
            x = x + y
        return _last_logits(cfg, params, x), cache

    return Model(cfg, init, hidden_fn, loss_fn, prefill, decode_step,
                 init_cache)


# --- xlstm -------------------------------------------------------------------

def _build_xlstm(cfg: LMConfig) -> Model:
    if cfg.xlstm is None:
        raise ValueError("an xlstm config needs xlstm")
    xc = cfg.xlstm
    g = xc.slstm_every
    if g > 0:
        if cfg.n_layers % g:
            raise ValueError("n_layers must divide slstm_every")
        ng = cfg.n_layers // g      # groups of (g-1) mLSTM + 1 sLSTM
        n_m = g - 1
    else:
        ng, n_m = 0, 0
    n_mlstm = ng * n_m if ng else cfg.n_layers

    def order():
        """("m", param index, cache row) and ("s", group, group) in the
        reference's order: each group's ``g - 1`` mLSTM blocks then its
        sLSTM block.  mLSTM params are ``[ng, g-1, ...]`` (``[L, ...]``
        without sLSTM blocks), their cache rows ``[ng * (g-1), ...]``."""
        if not ng:
            yield from (("m", i, i) for i in range(cfg.n_layers))
            return
        for gi in range(ng):
            yield from (("m", (gi, j), gi * n_m + j) for j in range(n_m))
            yield "s", gi, gi

    def init(generator: torch.Generator, device=None) -> Params:
        dev = generator.device if device is None else torch.device(device)
        p = _init_head(generator, cfg, dev)
        mlstm = _stacked(n_mlstm, lambda: {
            "pre": _init_norm(cfg, dev),
            "m": xlstm_mod.init_mlstm(generator, cfg.d_model, xc, cfg.dtype,
                                      dev)})
        if not ng:
            p["mlstm"] = mlstm
            return p
        p["mlstm"] = _map(lambda a: a.reshape((ng, n_m) + tuple(a.shape[1:])),
                          mlstm)
        p["slstm"] = _stacked(ng, lambda: {
            "pre": _init_norm(cfg, dev),
            "s": xlstm_mod.init_slstm(generator, cfg.d_model, xc, cfg.dtype,
                                      dev)})
        return p

    def hidden_fn(params: Params, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
        x = _embed_tokens(params, batch["tokens"])

        def m_body(x, lp):
            x = _resid_hint(cfg, x)
            return x + xlstm_mod.apply_mlstm(
                lp["m"], _apply_norm(cfg, lp["pre"], x), xc,
                use_kernel=cfg.use_gla_kernel)

        def s_body(x, lp):
            x = _resid_hint(cfg, x)
            return x + xlstm_mod.apply_slstm(
                lp["s"], _apply_norm(cfg, lp["pre"], x), xc)

        m, s = _maybe_remat(cfg, m_body), _maybe_remat(cfg, s_body)
        for kind, i, _ in order():
            if kind == "m":
                x = m(x, _index(params["mlstm"], i))
            else:
                x = s(x, _index(params["slstm"], i))
        return x

    def loss_fn(params, batch):
        return _loss_from_hidden(cfg, params, hidden_fn(params, batch),
                                 batch)

    def init_cache(batch: int, max_len: int = 0, device=None) -> Params:
        mc = xlstm_mod.init_mlstm_cache(batch, cfg.d_model, xc, cfg.dtype,
                                        device)
        cache = {"mlstm": _map(
            lambda a: a.new_zeros((n_mlstm,) + tuple(a.shape)), mc)}
        if ng:
            sc = xlstm_mod.init_slstm_cache(batch, cfg.d_model, xc, device)
            cache["slstm"] = _map(
                lambda a: a.new_zeros((ng,) + tuple(a.shape)), sc)
        return cache

    def prefill(params: Params, batch: Dict[str, torch.Tensor], max_len: int
                ) -> Tuple[torch.Tensor, Params]:
        x = _embed_tokens(params, batch["tokens"])
        cache = init_cache(x.shape[0], max_len, x.device)
        for kind, i, row in order():
            if kind == "m":
                lp = _index(params["mlstm"], i)
                y, c = xlstm_mod.prefill_mlstm(
                    lp["m"], _apply_norm(cfg, lp["pre"], x), xc,
                    use_kernel=cfg.use_gla_kernel)
                _write(_index(cache["mlstm"], row), c)
            else:
                lp = _index(params["slstm"], i)
                y, c = xlstm_mod.prefill_slstm(
                    lp["s"], _apply_norm(cfg, lp["pre"], x), xc)
                _write(_index(cache["slstm"], row), c)
            x = x + y
        return _last_logits(cfg, params, x), cache

    def decode_step(params: Params, tok: torch.Tensor, cache: Params,
                    pos: int) -> Tuple[torch.Tensor, Params]:
        x = _embed_tokens(params, tok)
        for kind, i, row in order():
            if kind == "m":
                lp = _index(params["mlstm"], i)
                lc = _index(cache["mlstm"], row)
                y, nc = xlstm_mod.decode_mlstm(
                    lp["m"], _apply_norm(cfg, lp["pre"], x), lc, xc)
            else:
                lp = _index(params["slstm"], i)
                lc = _index(cache["slstm"], row)
                y, nc = xlstm_mod.decode_slstm(
                    lp["s"], _apply_norm(cfg, lp["pre"], x), lc, xc)
            _write(lc, nc)
            x = x + y
        return _last_logits(cfg, params, x), cache

    return Model(cfg, init, hidden_fn, loss_fn, prefill, decode_step,
                 init_cache)


# --- encdec (whisper) --------------------------------------------------------

def _build_encdec(cfg: LMConfig) -> Model:
    if cfg.encoder_layers <= 0:
        raise ValueError("an encdec config needs encoder_layers > 0")
    heads = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                 head_dim=cfg.hd)

    def init_dec_block(generator: torch.Generator, device) -> Params:
        def attention():
            return attn.init_attention(generator, cfg.d_model, cfg.n_heads,
                                       cfg.n_kv_heads, cfg.hd, cfg.dtype,
                                       device=device)
        return {"ln1": _init_norm(cfg, device), "attn": attention(),
                "lnx": _init_norm(cfg, device), "xattn": attention(),
                "ln2": _init_norm(cfg, device),
                "mlp": _init_mlp(generator, cfg, device)}

    def init(generator: torch.Generator, device=None) -> Params:
        dev = generator.device if device is None else torch.device(device)
        p = _init_head(generator, cfg, dev)
        p["enc_layers"] = _stacked(cfg.encoder_layers,
                                   lambda: _init_block(generator, cfg, dev))
        p["enc_norm"] = _init_norm(cfg, dev)
        p["dec_layers"] = _stacked(cfg.n_layers,
                                   lambda: init_dec_block(generator, dev))
        return p

    def encode(params: Params, frames: torch.Tensor) -> torch.Tensor:
        """frames: [B, T_enc, D] precomputed embeddings (conv-frontend
        stub)."""
        T = frames.shape[1]
        x = frames.to(cfg.dtype) + sinusoidal_positions(
            T, cfg.d_model, frames.device).to(cfg.dtype)[None]
        block = _maybe_remat(cfg, lambda x, lp: _apply_block(
            cfg, lp, x, 0, causal=False))
        for i in range(cfg.encoder_layers):
            x = block(x, _index(params["enc_layers"], i))
        return _apply_norm(cfg, params["enc_norm"], x)

    def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
        x = _embed_tokens(params, tokens)
        return x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                        x.device).to(x.dtype)[None]

    def dec_block(p: Params, x: torch.Tensor, enc_out: torch.Tensor
                  ) -> torch.Tensor:
        x = _resid_hint(cfg, x)
        h = _apply_norm(cfg, p["ln1"], x)
        x = x + attn.self_attention(
            p["attn"], h, causal=True, rope_theta=cfg.rope_theta,
            use_flash=cfg.use_flash, block_q=cfg.attn_block_q, **heads)
        h = _apply_norm(cfg, p["lnx"], x)
        x = x + attn.cross_attention(p["xattn"], h, enc_out,
                                     block_q=cfg.attn_block_q, **heads)
        h = _apply_norm(cfg, p["ln2"], x)
        return x + _apply_mlp(cfg, p["mlp"], h)

    def hidden_fn(params: Params, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
        enc_out = encode(params, batch["frames"])
        x = embed(params, batch["tokens"])
        block = _maybe_remat(cfg, dec_block)
        for i in range(cfg.n_layers):
            x = block(_index(params["dec_layers"], i), x, enc_out)
        return x

    def loss_fn(params, batch):
        return _loss_from_hidden(cfg, params, hidden_fn(params, batch),
                                 batch)

    def init_cache(batch: int, max_len: int, enc_len: int = 0,
                   device=None) -> Params:
        def zeros(length):
            return torch.zeros((cfg.n_layers, batch, length, cfg.n_kv_heads,
                                cfg.hd), dtype=cfg.dtype, device=device)
        c = {"k": zeros(max_len), "v": zeros(max_len)}
        if enc_len:
            c["xk"], c["xv"] = zeros(enc_len), zeros(enc_len)
        return c

    def prefill(params: Params, batch: Dict[str, torch.Tensor], max_len: int
                ) -> Tuple[torch.Tensor, Params]:
        """The decoder's self-attention runs the plain ``mha`` here, as
        the reference's prefill does; the encoder takes ``use_flash``."""
        enc_out = encode(params, batch["frames"])
        x = embed(params, batch["tokens"])
        B, T = x.shape[:2]
        cache = init_cache(B, max_len, enc_out.shape[1], x.device)
        for i in range(cfg.n_layers):
            lp, lc = _index(params["dec_layers"], i), _index(cache, i)
            h = _apply_norm(cfg, lp["ln1"], x)
            q, k, v = attn._project_qkv(lp["attn"], h, h, **heads)
            if cfg.rope_theta > 0:
                pos = torch.arange(T, device=x.device)
                q = apply_rope(q, pos, cfg.rope_theta)
                k = apply_rope(k, pos, cfg.rope_theta)
            o = attn.mha(q, k, v, causal=True, block_q=cfg.attn_block_q)
            x = x + o.reshape(B, T, -1) @ lp["attn"]["wo"]
            h = _apply_norm(cfg, lp["lnx"], x)
            x = x + attn.cross_attention(lp["xattn"], h, enc_out,
                                         block_q=cfg.attn_block_q, **heads)
            h = _apply_norm(cfg, lp["ln2"], x)
            x = x + _apply_mlp(cfg, lp["mlp"], h)
            # cross-attention K/V are static per request: cache them.
            _, xk, xv = attn._project_qkv(lp["xattn"], h, enc_out, **heads)
            lc["k"][:, :T] = k.to(cfg.dtype)
            lc["v"][:, :T] = v.to(cfg.dtype)
            lc["xk"].copy_(xk)
            lc["xv"].copy_(xv)
        return _last_logits(cfg, params, x), cache

    def decode_step(params: Params, tok: torch.Tensor, cache: Params,
                    pos: int) -> Tuple[torch.Tensor, Params]:
        x = _embed_tokens(params, tok)          # [B, 1, D]
        B = x.shape[0]
        x = x + sinusoidal_position_at(pos, cfg.d_model, x.device).to(
            x.dtype)[None, None]
        for i in range(cfg.n_layers):
            lp, lc = _index(params["dec_layers"], i), _index(cache, i)
            h = _apply_norm(cfg, lp["ln1"], x)
            h, _, _ = attn.decode_self_attention(
                lp["attn"], h, lc["k"], lc["v"], pos,
                rope_theta=cfg.rope_theta, **heads)
            x = x + h
            h = _apply_norm(cfg, lp["lnx"], x)
            q = (h @ lp["xattn"]["wq"]).reshape(B, 1, cfg.n_heads, cfg.hd)
            o = attn.mha(q, lc["xk"], lc["xv"], causal=False)
            x = x + o.reshape(B, 1, -1) @ lp["xattn"]["wo"]
            h = _apply_norm(cfg, lp["ln2"], x)
            x = x + _apply_mlp(cfg, lp["mlp"], h)
        return _last_logits(cfg, params, x), cache

    return Model(cfg, init, hidden_fn, loss_fn, prefill, decode_step,
                 init_cache)


# ---------------------------------------------------------------------------
# Parameter accounting (roofline MODEL_FLOPS)
# ---------------------------------------------------------------------------

def param_count(params: Params) -> int:
    return sum(a.numel() for a in _leaves(params))


def active_param_count(cfg: LMConfig, params: Params) -> int:
    """Parameters touched per token (MoE: top_k of n_experts)."""
    total = param_count(params)
    if cfg.family != "moe" or cfg.moe is None:
        return total
    moe = params["layers"]["moe"]
    expert_leaves = sum(moe[name].numel()
                        for name in ("w_gate", "w_up", "w_down"))
    active = expert_leaves * cfg.moe.top_k / cfg.moe.n_experts
    return int(total - expert_leaves + active)
