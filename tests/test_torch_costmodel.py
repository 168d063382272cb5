"""Calibration of the port's cost model against the reference's: on the
same engines and the same (n, n) sample, both measure the same cast pairs
and op rates, so a calibration file written by one names what the other's
would.  A sample whose Haar levels do not halve (n 30: 15 then 8 and 7) is
skipped by both; one whose odd half has length 1 (n 6: 3, then 2 and 1)
broadcasts in both and is kept."""
import json

import pytest

from repro.core.costmodel import CostModel as JCostModel
from repro_torch.core.costmodel import CostModel as TCostModel


def _keys(path):
    with open(path) as f:
        blob = json.load(f)
    return (sorted(blob["cast_rate"]),
            {engine: sorted(ops) for engine, ops in blob["op_rate"].items()})


@pytest.mark.parametrize("n", [16, 30, 6])
def test_calibration_keys_match_the_reference(tmp_path, n):
    ref = JCostModel(str(tmp_path / "ref.calib.json"))
    ref.calibrate(n=n, repeats=1)
    port = TCostModel(str(tmp_path / "port.calib.json"))
    port.calibrate(n=n, repeats=1, device="cpu")
    assert ref.calibrated and port.calibrated
    want_casts, want_ops = _keys(tmp_path / "ref.calib.json")
    got_casts, got_ops = _keys(tmp_path / "port.calib.json")
    assert got_casts == want_casts
    assert got_ops == want_ops
    haar_kept = n != 30
    assert ("haar" in got_ops["dense_array"]) == haar_kept


def test_haar_refuses_a_level_that_does_not_halve():
    """The mismatch the reference's jnp arithmetic refuses is a ValueError
    in the port (calibration skips it by that type), not PyTorch's
    RuntimeError, which a device fault also raises."""
    import torch

    from repro_torch.core.engines import haar_1d_levels
    from repro_torch.kernels.haar import haar_ref
    x = torch.zeros((2, 30))
    for fn in (haar_ref, haar_1d_levels):
        with pytest.raises(ValueError, match="does not halve"):
            fn(x, 2)
        assert fn(x, 1).shape == (2, 30)
        assert fn(torch.zeros((2, 6)), 2).shape[0] == 2
