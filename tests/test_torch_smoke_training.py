"""``chip_smoke.py``'s training phases for the moe and xlstm families and
the flat train loop (phases 10-12), on the CPU.

* ``expected_lm_launches`` over hand-built schedules on a moe stack and
  an xlstm stack: flash per MoE block, the GLA per mLSTM block, nothing
  per sLSTM block, for each batch that passes it; two quantizer calls per
  int8 crossing.
* ``flat_launches``: the GLA twice per mLSTM block a step under remat.
* The phases rehearsed at tiny sizes, the card's calls stubbed and the
  kernel wrappers counting their CPU calls, so each phase's own launch
  check holds the counts above to what the code runs: ``run_lm_fleet``
  on f32 twins of fleet-moe and fleet-xlstm (4 blocks, d_model 64, T=32,
  B=16) under star schedules that cross the int8 wire (the real M=4
  plans cross once, at the embed), ``run_deep_cut`` on qwen2-moe-a2.7b's
  smoke twin and ``run_flat_loop`` on xlstm-350m's (T=32, B=2), whose
  resumed run must be bitwise the uninterrupted one.
"""
from __future__ import annotations

import dataclasses
import types

import pytest
import torch

import chip_smoke
import repro_torch.api as api
from repro_torch import optim, train
from repro_torch.configs import qwen2_moe_a2_7b, xlstm_350m
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.cost_model import MultiSchedule
from repro_torch.data.pipeline import make_lm_batch_fn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import gla_scan as gs
from repro_torch.kernels import int8_quant as iq
from repro_torch.models.lm import fleet_configs
from repro_torch.models.lm import model as lm_model
from repro_torch.models.lm.layerstack import lm_layerstack
from repro_torch.train import step as train_step
from tests.test_torch_serve import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

KERNELS = {"int8_quant": iq, "flash_attention": fa, "gla_scan": gs}
STAR = ("device_0", "device_1", "device_2", "device_3")


def tiny(cfg, T: int):
    """An f32 twin of a fleet stack: 4 blocks, d_model 64, vocab 512.

    The MoE twin routes each sequence alone.  At these widths its int8
    gap moves with the grouping and the split, by routing flips, in the
    JAX package exactly as in the port: with fleet-moe's groups of two
    sequences it reads 0.0316 at step 3 on ``AT_EMBED``, and 0.0255 on
    the card plan's split (tests/test_torch_int8_gap.py holds the port
    to JAX there), past the 0.02 that the card's fleet-moe keeps at its
    published grouping.  The rehearsal checks the phase's launches,
    floor and f32 check, not the card's numbers."""
    kw = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
              vocab=512, dtype=torch.float32)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, d_ff_expert=64,
                                        group_size=T)
    else:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, n_heads=2, chunk=16,
                                          slstm_every=2)
    return cfg.variant(**kw)


def test_launches_per_moe_block_and_per_batch():
    stack = lm_layerstack(tiny(fleet_configs.FLEET_MOE, 32), 32)
    assert stack.block_kinds == ("embed",) + ("moe",) * 4 + ("head",)
    # stream 0 leaves worker o's batch at cut 2, stream 1 at cut 0 (no
    # crossing), stream 2 is empty; TASK L's stream at cut 3
    sched = MultiSchedule("cloud", "edge", STAR[:3], m_s=(2, 0, 4),
                          m_l=3, b_o=3, b_s=(2, 2, 0), b_l=2)
    # blocks 1..4: o's batch at each, plus stream 0 below cut 2 (block 1)
    # and L below cut 3 (blocks 1, 2)
    assert chip_smoke.expected_lm_launches(stack, sched, "int8") == {
        "flash_attention": 4 + 1 + 2, "gla_scan": 0, "int8_quant": 4}
    assert chip_smoke.expected_lm_launches(stack, sched, "none")[
        "int8_quant"] == 0


def test_launches_per_mlstm_block_none_per_slstm_block():
    stack = lm_layerstack(tiny(fleet_configs.FLEET_XLSTM, 32), 32)
    assert stack.block_kinds == ("embed", "mlstm", "slstm", "mlstm",
                                 "slstm", "head")
    sched = MultiSchedule("cloud", "edge", ("device_0",), m_s=(4,), m_l=5,
                          b_o=0, b_s=(3,), b_l=2)
    # o's batch is empty until cut 4: the mLSTM at 1 runs for stream 0
    # and L, the one at 3 for stream 0 and L as well
    assert chip_smoke.expected_lm_launches(stack, sched, "int8") == {
        "flash_attention": 0, "gla_scan": 4, "int8_quant": 4}


def test_flat_launches_count_the_remat_forward():
    cfg = xlstm_350m.FULL
    assert cfg.remat and chip_smoke.serve_launches(cfg)["gla_scan"] == 21
    assert chip_smoke.flat_launches(cfg) == {
        "int8_quant": 0, "flash_attention": 0, "gla_scan": 42}
    assert chip_smoke.flat_launches(cfg.variant(remat=False))[
        "gla_scan"] == 21


@pytest.mark.parametrize("algorithms", [True, False])
def test_deterministic_restores_the_flags(algorithms):
    """Phase 12 holds PyTorch's algorithms too, phases 5 and 8 cuDNN's
    alone."""
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark,
              torch.are_deterministic_algorithms_enabled())
    with chip_smoke.deterministic(torch, algorithms=algorithms):
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.benchmark
        assert torch.are_deterministic_algorithms_enabled() == (
            algorithms or before[2])
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.are_deterministic_algorithms_enabled()) == before


@pytest.fixture
def deterministic_imported():
    """``torch.use_deterministic_algorithms`` imports the compiler stack
    on its first call, which must not see ``cpu_card``'s patched
    ``torch.Generator``."""
    torch.use_deterministic_algorithms(
        torch.are_deterministic_algorithms_enabled(),
        warn_only=torch.is_deterministic_algorithms_warn_only_enabled())


@pytest.fixture
def cpu_card(monkeypatch):
    """The card's calls stubbed for a CPU rehearsal; each kernel wrapper
    counts its CPU calls as a launch (not its meta calls, as on the
    card)."""
    make = torch.Generator
    monkeypatch.setattr(torch, "Generator", lambda device=None: make())
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda: 0)
    monkeypatch.setattr(chip_smoke, "profile_call", lambda torch, fn, label: (
        fn(), {"device_busy_ms": 0.0, "wall_ms": 1.0})[1])
    for mod in (api, train_step):
        monkeypatch.setattr(mod, "resolve_device",
                            lambda device=None: torch.device("cpu"))
    for mod, fn in ((fa, "flash_attention_fwd"), (gs, "gla_scan_fwd"),
                    (iq, "wire_qdq_int8")):
        def counted(*args, _mod=mod, _fn=getattr(mod, fn), **kw):
            _mod.launches += args[0].device.type != "meta"
            return _fn(*args, **kw)
        monkeypatch.setattr(mod, fn, counted)
    chip_smoke.zero_counters(KERNELS)


def forced(sched):
    """The facade with ``plan`` returning ``sched`` in place of the
    solver's choice (a tiny stack's own plan crosses no wire)."""
    def plan(stack, fleet, B):
        p = api.plan(stack, fleet, B)
        return dataclasses.replace(p, result=types.SimpleNamespace(
            schedule=sched, t_total=0.0))
    return types.SimpleNamespace(Fleet=api.Fleet, plan=plan)


# the real M=4 plans' shape (TASK L's stream crosses at the embed) and a
# stream that crosses after block 1 beside TASK L's after block 2
AT_EMBED = MultiSchedule("cloud", "edge", STAR, m_s=(0, 0, 0, 0), m_l=1,
                         b_o=6, b_s=(0, 0, 0, 0), b_l=10)
DEEP = MultiSchedule("cloud", "edge", STAR, m_s=(2, 0, 0, 0), m_l=3, b_o=6,
                     b_s=(4, 0, 0, 0), b_l=6)


@pytest.mark.parametrize("name", ["FLEET_MOE", "FLEET_XLSTM"])
def test_run_lm_fleet_rehearsed(name, cpu_card, monkeypatch):
    """The whole phase on the real M=4 plans' shape (``AT_EMBED``):
    launches, the per-token int8 gap and its limit, the f32 check
    against vanilla SGD.  ``test_lm_steps_rehearsed_through_the_blocks``
    runs the steps on crossings between blocks (``DEEP``)."""
    T = 32
    monkeypatch.setattr(chip_smoke, "LM_B", 16)
    cfg = getattr(fleet_configs, name)
    stack = lm_layerstack(tiny(cfg, T), T, backend="cuda")
    from repro_torch.core import hybrid_step as hs
    floor = cfg.name in chip_smoke.GAP_FLOOR_STACKS
    assert floor == (name == "FLEET_XLSTM")
    run = chip_smoke.run_lm_fleet(torch, forced(AT_EMBED), hs, KERNELS,
                                  stack, 4, gap_floor=floor)
    # an f32 twin's floor is nil: the f32 run is the wire="none" run
    assert run["precision_floor"] == [0.0] * chip_smoke.LM_STEPS
    assert run["gap_limit"] == chip_smoke.E2E_LOSS_GAP
    want = chip_smoke.expected_lm_launches(stack, AT_EMBED, "int8")
    assert run["launches"] == {k: v * chip_smoke.LM_STEPS
                               for k, v in want.items()}
    kernel = "flash_attention" if name == "FLEET_MOE" else "gla_scan"
    assert want == {"flash_attention": 0, "gla_scan": 0, "int8_quant": 2,
                    kernel: 4 if kernel == "flash_attention" else 2}
    assert run["reference"]["worst"]["hybrid_vs_ref"] <= \
        chip_smoke.REF_UPDATE_RTOL


@pytest.mark.parametrize("name,want", [
    ("FLEET_MOE", {"flash_attention": 4 + 1 + 2, "gla_scan": 0}),
    ("FLEET_XLSTM", {"flash_attention": 0, "gla_scan": 3 + 1})])
def test_lm_steps_rehearsed_through_the_blocks(name, want, cpu_card,
                                               monkeypatch):
    """Launches per block and batch, and two quantizer calls per
    crossing, with streams that pass blocks before they merge: worker
    o's batch runs every block, stream 0 block 1, L blocks 1 and 2 (the
    xLSTM's mLSTM blocks are 1 and 3)."""
    T = 32
    stack = lm_layerstack(tiny(getattr(fleet_configs, name), T), T,
                          backend="cuda")
    p = forced(DEEP).plan(stack, api.Fleet.lm_default(m=4, wire="int8"), 16)
    x, y = stack.dummy_batch(torch.Generator().manual_seed(1), 16)
    run = chip_smoke.lm_steps(torch, KERNELS, p, p.init_params(seed=0), x,
                              y, chip_smoke.LM_LR, 2, name)
    assert run["launches_per_step"] == dict(want, int8_quant=4)
    assert run["launches"] == {k: 2 * v for k, v in
                               run["launches_per_step"].items()}


def test_run_deep_cut_rehearsed(cpu_card):
    stack = lm_layerstack(qwen2_moe_a2_7b.SMOKE, 32, backend="cuda")
    run = chip_smoke.run_deep_cut(torch, api, KERNELS, stack, 2, 1e-3, 3,
                                  ("flash_attention",))
    assert run["launches"]["flash_attention"] >= 3 * 2
    assert run["params"] == sum(m.param_count for m in stack.cut_meta())


def test_run_flat_loop_rehearsed(deterministic_imported, cpu_card,
                                 monkeypatch, tmp_path):
    for k, v in (("FLAT_B", 2), ("FLAT_T", 32)):
        monkeypatch.setattr(chip_smoke, k, v)
    cfg = xlstm_350m.SMOKE.variant(use_flash=True, use_gla_kernel=True)
    with chip_smoke.deterministic(torch):
        run = chip_smoke.run_flat_loop(
            torch, KERNELS, lm_model, optim, train, make_lm_batch_fn,
            ShapeSpec("flat", 32, 2, "train"), cfg, tmp_path)
    assert run["resume_bitwise"]
    assert run["launches"]["gla_scan"] == 4 * 2 * chip_smoke.FLAT_STEPS
    assert run["launches_per_step"] == chip_smoke.flat_launches(cfg)
    assert len(run["losses"]) == chip_smoke.FLAT_STEPS
    assert run["loss_after_on_batch0"] < run["losses"][0]
