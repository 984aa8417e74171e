"""The golden solves that bench.py and chip_smoke.py run on the card
(justrelax_tpu/utils/goldens.py), here on the CPU in f64 and f32, against
the same thresholds the card is held to."""

import pytest

from justrelax_tpu.utils.goldens import DTYPES, GOLDENS, run_golden


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden(name, dtype):
    res = run_golden(name, dtype)
    bad = [c for c in res["checks"] if not c["ok"]]
    assert res["pass"] and not bad, bad
    assert all(c["why"] for c in res["checks"])  # every limit has a reason


def test_unknown_dtype_is_refused():
    with pytest.raises(ValueError, match="dtype"):
        run_golden("solcx", "bfloat16")
