"""``correct`` comes out false with the timed path broken underneath (a
step that returns its state unchanged; half of each batch left out, the
mean taken over the rest), and the control, the reference at TF32 put in
the program's place, comes out not correct through the harness's own
verdict at the tiny cells' limits."""
import pytest

import tiny


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny.make_checkout(str(tmp_path_factory.mktemp("co") / "co"))


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("cell", ["ctgcn_c.tiny.uneg", "gcrn.tiny.uneg"])
def test_a_fault_is_not_correct(checkout, cell, fault, tmp_path):
    out = tiny.run_cpu(checkout, cell, 99, fault=fault, tmp=str(tmp_path))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["ctgcn_c.tiny.uneg", "gcrn.tiny.uneg"])
def test_the_control_fails_a_limit(checkout, cell, tmp_path):
    out = tiny.run_cpu(checkout, cell, 5, control=True, tmp=str(tmp_path))
    assert out["correct"]
    assert out["control_correct"] is False, out["control_checks"]
    # the exact checks are the run's own, so a limit of the numbers fails
    failed = [k for k, (v, lim) in out["control_checks"].items()
              if not v <= lim]
    assert failed and all(lim > 0 for k, (_, lim)
                          in out["control_checks"].items()
                          if k in failed), out["control_checks"]
