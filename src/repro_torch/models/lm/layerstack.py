"""LayerStack adapter for the LM model zoo (DESIGN.md §8).

The port of :mod:`repro.models.lm.layerstack`.  An LM config's blocks
become an ordered chain of cut-points for the planner and the hybrid
engine::

    [embed]  [block_1 ... block_K]  [head]

* ``embed`` pins to the stream start (token ids are tiny on the wire, the
  table is huge), ``head`` to the stream end (its output is ``T x V``).
* every block is one cut-point with the JAX package's analytic meta
  (matmul FLOPs, params, bf16 forward / f32 backward wire bytes), so
  profiles and schedules are ``==`` across the two packages.

Families and their block kinds:

* ``dense``: ``attn`` blocks (GQA + MLP, the local/global window pattern
  kept per layer).
* ``moe``: ``moe`` blocks, the dense skeleton with a routed-MoE MLP, in
  the ``dense`` window pattern.
* ``zamba``: ``mamba2`` (SSD) blocks with an ``attn`` block after every
  ``shared_attn_every``-th one.  The cut-point protocol needs disjoint
  per-cut params, so the recurring attention block is untied: each
  occurrence is its own cut-point with its own weights.
* ``xlstm``: ``mlstm`` blocks (the GLA primitive) with an ``slstm``
  block at every ``slstm_every``-th position.

``encdec`` (a second input stream) and prefix-embedding configs
(``n_frontend_tokens > 0``) raise ``ValueError``: the chain is linear.

MoE caveat: ``apply_moe`` groups tokens; a sub-batch of ``b`` samples
dispatches ``b*T`` tokens, which must be a multiple of
``min(group_size, b*T)``.  Which tokens a full expert drops depends on
the group's composition, so the hybrid step is exactly batch-B SGD when
capacity is lossless or when every group the split runs is one of the
whole batch's: every group one sequence (``group_size == seq_len``), or
every MoE block run on merged streams (the merge keeps the batch's
order) whose sub-batches hold whole groups; within routing-drop noise
otherwise.

``backend="cuda"`` routes attention and MoE blocks onto the CUDA
flash-attention kernel and Mamba2 and mLSTM blocks onto the CUDA GLA
scan (through :mod:`repro_torch.kernels.ops`; for tensors on the CPU the
kernels' plain versions run).  ``"ref"`` keeps the plain PyTorch path.
The meta is backend-independent.  :func:`block_flops` /
:func:`crosscheck_flops` are the JAX module's HLO cross-checks
(``hlo_block_flops`` / ``hlo_crosscheck_flops``): one cut-point's
forward counted under ``FlopCounterMode`` in place of the compiled
HLO's dot count.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.layerstack import CutMeta, LayerStack
from repro_torch.models.lm import ssm as ssm_mod
from repro_torch.models.lm import xlstm as xlstm_mod
from repro_torch.models.lm.common import truncated_normal_init
from repro_torch.models.lm.model import (LMConfig, _apply_block,
                                         _apply_norm, _group_layout,
                                         _init_block, _init_norm,
                                         _resid_hint)

Params = List[Any]

SUPPORTED_FAMILIES = ("dense", "moe", "zamba", "xlstm")

# cfg.family -> the block-family label used in benchmarks/docs.
FAMILY_LABELS = {"dense": "attention", "moe": "moe", "zamba": "gla",
                 "xlstm": "xlstm"}


@dataclasses.dataclass(frozen=True)
class _BlockSpec:
    kind: str          # embed | attn | moe | mamba2 | mlstm | slstm | head
    window: int = 0    # attention window (0 = full) — attn blocks only


def _block_plan(cfg: LMConfig) -> List[_BlockSpec]:
    """The linear cut-point chain of one LM config."""
    if cfg.family not in SUPPORTED_FAMILIES:
        raise ValueError(
            f"family {cfg.family!r} has no LayerStack adapter "
            f"(supported: {SUPPORTED_FAMILIES})")
    if cfg.n_frontend_tokens > 0:
        raise ValueError("prefix-embedding (VLM/audio) configs are not "
                         "cut-point schedulable")
    plan = [_BlockSpec("embed")]
    if cfg.family in ("dense", "moe"):
        if cfg.family == "moe" and cfg.moe is None:
            raise ValueError("a moe config needs moe")
        kind = "moe" if cfg.family == "moe" else "attn"
        ng, g, _ = _group_layout(cfg)
        for i in range(cfg.n_layers):
            # gemma3-style pattern: each group is (g-1) local + 1 global.
            is_global = ng > 0 and i < ng * g and i % g == g - 1
            plan.append(_BlockSpec(kind,
                                   0 if is_global else cfg.sliding_window))
    elif cfg.family == "zamba":
        if cfg.ssm is None or cfg.shared_attn_every <= 0:
            raise ValueError("a zamba config needs ssm and "
                             "shared_attn_every > 0")
        g = cfg.shared_attn_every
        for i in range(cfg.n_layers):
            plan.append(_BlockSpec("mamba2"))
            if (i + 1) % g == 0:
                plan.append(_BlockSpec("attn", cfg.sliding_window))
    else:
        if cfg.xlstm is None:
            raise ValueError("an xlstm config needs xlstm")
        g = cfg.xlstm.slstm_every
        for i in range(cfg.n_layers):
            plan.append(_BlockSpec(
                "slstm" if g > 0 and i % g == g - 1 else "mlstm"))
    plan.append(_BlockSpec("head"))
    return plan


# ---------------------------------------------------------------------------
# Analytic per-block meta (matmul FLOPs only), as in the JAX module.
# ---------------------------------------------------------------------------


def _norm_params(cfg: LMConfig) -> int:
    return 2 * cfg.d_model if cfg.norm == "layer" else cfg.d_model


def _attn_meta(cfg: LMConfig, T: int) -> Tuple[int, float]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    params = D * H * hd + 2 * D * KV * hd + H * hd * D
    if cfg.qkv_bias:
        params += H * hd + 2 * KV * hd
    # qkv + wo projections, then the dense (masked) T x T score/AV matmuls.
    flops = 2 * T * D * (H * hd) + 4 * T * D * (KV * hd) \
        + 4 * T * T * H * hd + 2 * T * (H * hd) * D
    return params, float(flops)


def _mlp_meta(cfg: LMConfig, T: int) -> Tuple[int, float]:
    D, dff = cfg.d_model, cfg.d_ff
    if cfg.mlp == "gelu":
        return 2 * D * dff + dff + D, float(4 * T * D * dff)
    return 3 * D * dff, float(6 * T * D * dff)


def _moe_meta(cfg: LMConfig, T: int) -> Tuple[int, float]:
    moe = cfg.moe
    D = cfg.d_model
    E, K, Fe = moe.n_experts, moe.top_k, moe.d_ff_expert
    G = min(moe.group_size, T)          # nominal single-sample grouping
    C = max(int(G * K * moe.capacity_factor / E), 1)
    params = D * E + 3 * E * D * Fe
    # router + dispatch/combine einsums + expert SwiGLU + one-hot builds.
    per_tok = 2 * D * E + 4 * E * C * D + 6 * E * C * D * Fe / G \
        + 4 * K * E * C
    if moe.n_shared > 0:
        width = moe.d_ff_shared or moe.n_shared * Fe
        params += 3 * D * width
        per_tok += 6 * D * width
    return params, float(T * per_tok)


def _gla_flops(nh: int, dk: int, dv: int, W: int, T: int) -> float:
    """Chunked-GLA matmul FLOPs for T tokens: intra-chunk quadratic scores
    (2*W*dk) + intra AV (2*W*dv) + chunk-state build and query (4*dk*dv),
    per token per head."""
    return float(T * nh * (2 * W * (dk + dv) + 4 * dk * dv))


def _mamba2_meta(cfg: LMConfig, T: int) -> Tuple[int, float]:
    sc = cfg.ssm
    D = cfg.d_model
    di = ssm_mod.d_inner(D, sc)
    nh = ssm_mod.n_ssm_heads(D, sc)
    conv_ch = di + 2 * sc.d_state
    params = D * (2 * di + 2 * sc.d_state + nh) + sc.d_conv * conv_ch \
        + conv_ch + 3 * nh + di + di * D + _norm_params(cfg)
    W = min(sc.chunk, T)
    flops = 2 * T * D * (2 * di + 2 * sc.d_state + nh) \
        + 2 * T * sc.d_conv * conv_ch \
        + _gla_flops(nh, sc.d_state, sc.head_dim, W, T) \
        + 2 * T * di * D
    return params, float(flops)


def _mlstm_meta(cfg: LMConfig, T: int) -> Tuple[int, float]:
    xc = cfg.xlstm
    D = cfg.d_model
    di = xc.expand * D
    hd = di // xc.n_heads
    params = D * 2 * di + xc.d_conv * di + di + 3 * di * di \
        + di * 2 * xc.n_heads + 2 * xc.n_heads + di + di * D \
        + _norm_params(cfg)
    W = min(xc.chunk, T)
    flops = 2 * T * D * 2 * di + 2 * T * xc.d_conv * di \
        + 6 * T * di * di + 2 * T * di * 2 * xc.n_heads \
        + _gla_flops(xc.n_heads, hd, hd, W, T) \
        + 2 * T * di * D
    return params, float(flops)


def _slstm_meta(cfg: LMConfig, T: int) -> Tuple[int, float]:
    xc = cfg.xlstm
    D = cfg.d_model
    hd = D // xc.n_heads
    params = D * 4 * D + xc.n_heads * hd * 4 * hd + 4 * D + D + D * D \
        + _norm_params(cfg)
    # input projection + per-step recurrent matmul + output projection.
    flops = 2 * T * D * 4 * D + 8 * T * D * hd + 2 * T * D * D
    return params, float(flops)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# The adapter.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LMLayerStack(LayerStack):
    """An LM config's block stack behind the :class:`LayerStack` protocol.

    ``seq_len`` fixes the per-*sample* meta: one sample is one sequence of
    ``seq_len`` tokens, so every schedule's ``b_*`` counts sequences.
    """
    cfg: LMConfig
    seq_len: int
    backend: str = "ref"

    def __post_init__(self) -> None:
        if self.backend not in ("ref", "cuda"):
            raise ValueError(f"unknown backend {self.backend!r}; pick "
                             f"'ref' or 'cuda'")
        if self.backend == "cuda":
            self.cfg = self.cfg.variant(use_flash=True, use_gla_kernel=True)
        self._plan = _block_plan(self.cfg)

    @property
    def name(self) -> str:                        # type: ignore[override]
        return f"{self.cfg.name}@T{self.seq_len}"

    @property
    def family(self) -> str:
        return FAMILY_LABELS[self.cfg.family]

    @property
    def num_layers(self) -> int:
        return len(self._plan)

    @property
    def block_kinds(self) -> Tuple[str, ...]:
        """The kind of each cut-point: embed, attn, moe, mamba2, mlstm,
        slstm or head."""
        return tuple(spec.kind for spec in self._plan)

    # ---- metadata ------------------------------------------------------

    def cut_meta(self) -> List[CutMeta]:
        cfg, T = self.cfg, self.seq_len
        act_elem = _itemsize(cfg.dtype)
        hid_elems = float(T * cfg.d_model)
        hid_act = hid_elems * act_elem
        hid_grad = hid_elems * 4                       # f32 gradient wire
        metas: List[CutMeta] = []
        counts = {k: 0 for k in ("attn", "moe", "mamba2", "mlstm", "slstm")}
        for spec in self._plan:
            if spec.kind == "embed":
                metas.append(CutMeta(
                    name="embed", param_count=cfg.vocab * cfg.d_model,
                    flops_fwd=0.0, flops_bwd=0.0,
                    act_bytes=hid_act, grad_bytes=hid_grad,
                    act_elems=hid_elems, grad_elems=hid_elems,
                    param_bytes=float(cfg.vocab * cfg.d_model * act_elem)))
                continue
            if spec.kind == "head":
                p = cfg.d_model * cfg.vocab + _norm_params(cfg)
                flops = float(2 * T * cfg.d_model * cfg.vocab)
                metas.append(CutMeta(
                    name="head", param_count=p, flops_fwd=flops,
                    flops_bwd=2.0 * flops,
                    act_bytes=float(T * cfg.vocab * act_elem),
                    grad_bytes=float(T * cfg.vocab * 4),
                    act_elems=float(T * cfg.vocab),
                    grad_elems=float(T * cfg.vocab),
                    param_bytes=float(p * act_elem)))
                continue
            if spec.kind in ("attn", "moe"):
                pa, fa = _attn_meta(cfg, T)
                pm, fm = (_mlp_meta if spec.kind == "attn"
                          else _moe_meta)(cfg, T)
                p, flops = pa + pm + 2 * _norm_params(cfg), fa + fm
            elif spec.kind == "mamba2":
                p, flops = _mamba2_meta(cfg, T)
            elif spec.kind == "mlstm":
                p, flops = _mlstm_meta(cfg, T)
            else:
                p, flops = _slstm_meta(cfg, T)
            counts[spec.kind] += 1
            metas.append(CutMeta(
                name=f"{spec.kind}{counts[spec.kind]}", param_count=p,
                flops_fwd=flops, flops_bwd=2.0 * flops,
                act_bytes=hid_act, grad_bytes=hid_grad,
                act_elems=hid_elems, grad_elems=hid_elems,
                param_bytes=float(p * act_elem)))
        return metas

    def default_sample_bytes(self) -> float:
        return 8.0 * self.seq_len        # int32 tokens + int32 targets

    # ---- params --------------------------------------------------------

    def init(self, generator: torch.Generator,
             device: Optional[torch.device] = None) -> Params:
        """Truncated-normal weights drawn from ``generator`` (on its own
        device) and placed on ``device`` (default: the generator's), one
        nested dict per cut-point in the JAX package's layout."""
        cfg = self.cfg
        dev = generator.device if device is None else torch.device(device)
        params: Params = []
        for spec in self._plan:
            if spec.kind == "embed":
                params.append({"embed": truncated_normal_init(
                    generator, (cfg.vocab, cfg.d_model), 1.0, cfg.dtype,
                    dev)})
            elif spec.kind == "head":
                params.append({
                    "final_norm": _init_norm(cfg, dev),
                    "lm_head": truncated_normal_init(
                        generator, (cfg.d_model, cfg.vocab), 1.0, cfg.dtype,
                        dev)})
            elif spec.kind in ("attn", "moe"):
                params.append(_init_block(generator, cfg, dev))
            elif spec.kind == "mamba2":
                params.append({"pre": _init_norm(cfg, dev),
                               "m": ssm_mod.init_mamba2(
                                   generator, cfg.d_model, cfg.ssm,
                                   cfg.dtype, dev)})
            elif spec.kind == "mlstm":
                params.append({"pre": _init_norm(cfg, dev),
                               "m": xlstm_mod.init_mlstm(
                                   generator, cfg.d_model, cfg.xlstm,
                                   cfg.dtype, dev)})
            else:
                params.append({"pre": _init_norm(cfg, dev),
                               "s": xlstm_mod.init_slstm(
                                   generator, cfg.d_model, cfg.xlstm,
                                   cfg.dtype, dev)})
        return params

    # ---- execution -----------------------------------------------------

    def apply_segment(self, params: Params, x: torch.Tensor, start: int,
                      stop: int) -> torch.Tensor:
        cfg = self.cfg
        for i in range(start, stop):
            spec, p = self._plan[i], params[i]
            if spec.kind == "embed":
                x = F.embedding(x.long(), p["embed"])
            elif spec.kind == "head":
                x = _apply_norm(cfg, p["final_norm"], x) @ p["lm_head"]
            elif spec.kind in ("attn", "moe"):
                x = _apply_block(cfg, p, x, spec.window)
            elif spec.kind == "mamba2":
                x = _resid_hint(cfg, x)
                hn = _apply_norm(cfg, p["pre"], x)
                x = x + ssm_mod.apply_mamba2(p["m"], hn, cfg.ssm,
                                             use_kernel=cfg.use_gla_kernel)
            elif spec.kind == "mlstm":
                x = _resid_hint(cfg, x)
                hn = _apply_norm(cfg, p["pre"], x)
                x = x + xlstm_mod.apply_mlstm(p["m"], hn, cfg.xlstm,
                                              use_kernel=cfg.use_gla_kernel)
            else:
                x = _resid_hint(cfg, x)
                hn = _apply_norm(cfg, p["pre"], x)
                x = x + xlstm_mod.apply_slstm(p["s"], hn, cfg.xlstm)
        return x

    def sum_loss(self, logits: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
        """Per-sequence-sum token cross-entropy (f32)."""
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(-1, labels.long()[..., None]).sum()

    def dummy_batch(self, generator: torch.Generator, batch: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uniform random token ids and targets ``[batch, seq_len]``
        (int64) on the generator's device."""
        shape = (batch, self.seq_len)
        dev = generator.device
        x = torch.randint(0, self.cfg.vocab, shape, generator=generator,
                          device=dev)
        y = torch.randint(0, self.cfg.vocab, shape, generator=generator,
                          device=dev)
        return x, y


def lm_layerstack(cfg: LMConfig, seq_len: int,
                  backend: str = "ref") -> LMLayerStack:
    """Build the LayerStack adapter over ``cfg``'s block stack.

    ``backend="cuda"`` routes attention and MoE blocks onto
    ``kernels/csrc/flash_attention.cu`` and Mamba2 and mLSTM blocks onto
    ``kernels/csrc/gla_scan.cu``; ``"ref"`` (default) keeps the plain
    PyTorch path.  Profiles and schedules are backend-independent."""
    return LMLayerStack(cfg=cfg, seq_len=seq_len, backend=backend)


# ---------------------------------------------------------------------------
# FLOP cross-check: run one cut-point's forward segment and count its
# FLOPs with FlopCounterMode (the JAX module counts the compiled HLO's
# dots) — the guard that keeps the analytic meta honest as block
# implementations evolve.
# ---------------------------------------------------------------------------


def block_flops(stack: LMLayerStack, cut: int, batch: int = 1,
                device=None) -> float:
    """Counted per-sample FLOPs of cut-point ``cut``'s forward, on
    ``device`` (default ``cuda``; ``meta`` counts shapes alone).  Params
    and the segment's input come from seeded draws (seeds 0 and 1, as the
    JAX module's keys); a CUDA kernel on the segment's path is one opaque
    op to the counter, so cross-check a ``"ref"`` stack."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    gdev = "cpu" if dev.type == "meta" else dev
    params = stack.init(torch.Generator(device=gdev).manual_seed(0), dev)
    with torch.no_grad():
        if dev.type == "meta":
            x = torch.empty((batch, stack.seq_len), dtype=torch.int64,
                            device=dev)
        else:
            x, _ = stack.dummy_batch(
                torch.Generator(device=dev).manual_seed(1), batch)
        xi = x if cut == 0 else stack.apply_segment(params, x, 0, cut)
        counter = FlopCounterMode(display=False)
        with counter:
            stack.apply_segment(params, xi, cut, cut + 1)
    return float(counter.get_total_flops()) / batch


def crosscheck_flops(stack: LMLayerStack, cut: int, batch: int = 1,
                     device=None) -> Tuple[float, float]:
    """(analytic, counted) per-sample forward FLOPs of one cut."""
    analytic = stack.cut_meta()[cut].flops_fwd
    return analytic, block_flops(stack, cut, batch, device)
