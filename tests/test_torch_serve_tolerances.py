"""``chip_smoke.SERVE_TOL`` of the moe, xlstm and encdec archs that
``chip_smoke.py`` serves, measured as tests/test_torch_serve_kernels.py
measures it for zamba2-7b and qwen2.5-3b (its ``CUT`` configs, B=2,
T=512, whisper-base at 64 tokens over 1,500 frames, the kernels'
rounding emulated by route; MoE through ``chip_smoke.moe_checks``, with
one side's routing replayed).  A file of its own, so the serving tests
spread over the workers.
"""
from __future__ import annotations

import pytest

import chip_smoke
from tests.test_torch_serve import one_thread  # noqa: F401
from tests.test_torch_serve_families import FAMILIES
from tests.test_torch_serve_kernels import (DENSE_GQA, DENSE_WIDE,
                                            DENSE_ZAMBA,
                                            check_serving_tolerances,
                                            emulated_kernels)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NEW = tuple(a for a in chip_smoke.SERVE_ARCHS
            if a not in DENSE_ZAMBA + DENSE_WIDE + DENSE_GQA)


def test_every_served_arch_has_its_tolerance_measured():
    assert set(NEW) == set(FAMILIES)
    assert set(NEW) | set(DENSE_ZAMBA) | set(DENSE_WIDE) | \
        set(DENSE_GQA) == set(chip_smoke.SERVE_ARCHS)


@pytest.mark.parametrize("arch", NEW)
def test_chip_serving_tolerances_hold_twice_the_emulated_bf16_error(
        arch, emulated_kernels):
    check_serving_tolerances(arch)
