"""``chip_smoke.SERVE_TOL`` of phi3-medium-14b (40 query heads over 10 KV
heads) and granite-20b (48 over one: MQA), measured as
tests/test_torch_serve_kernels.py measures qwen2.5-3b's (its ``CUT``
configs: served depth, heads, KV heads and head widths kept; d_model, FF
and vocab cut; B=2, T=512; the bf16 kernels' rounding emulated).  A file
of its own, so the serving tests spread over the workers.
"""
from __future__ import annotations

import pytest

from tests.test_torch_serve import one_thread  # noqa: F401
from tests.test_torch_serve_kernels import (DENSE_GQA,
                                            check_serving_tolerances,
                                            emulated_kernels)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("arch", DENSE_GQA)
def test_chip_serving_tolerances_hold_twice_the_emulated_bf16_error(
        arch, emulated_kernels):
    check_serving_tolerances(arch)
