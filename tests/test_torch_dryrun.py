"""The port's check entry points (`sambert_hifigan_tpu_torch.dryrun`) against
the JAX package's `__graft_entry__.py`, on the CPU: entry()'s forward has
the JAX entry()'s output shape, dryrun_multichip(2) runs its "dp" stage
on 2 gloo ranks to a passing verdict and no other (the JAX condition of the
"dp x tp" stage: an even n >= 4), and dryrun_multichip(4) runs both stages,
"dp x tp" at data 2 x model 2, to passing verdicts.
"""

# bind the stdlib `profile` before a test puts scripts/ (and its profile.py) on
# sys.path: torch.optim imports torch._dynamo, and so cProfile, at first use
import cProfile  # noqa: F401

import jax
import torch

from sambert_hifigan_tpu_torch import dryrun
from tests.test_torch_discriminators import one_torch_thread  # noqa: F401 (a fixture)


def test_entry_has_the_jax_entry_shape():
    import __graft_entry__ as graft

    fn_j, args_j = graft.entry()
    want = jax.eval_shape(fn_j, *args_j).shape
    fn, args = dryrun.entry(device="cpu")
    with torch.no_grad():
        out = fn(*args)
    assert tuple(out.shape) == tuple(want) == (2, 128, 80)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


def test_dryrun_multichip_dp_stage_passes(capsys):
    assert dryrun.dryrun_multichip(2, device="cpu", timeout=300) is True
    out = capsys.readouterr().out
    assert "[dryrun] stage dp: PASS" in out
    assert "acoustic step ok" in out and "vocoder GAN step ok" in out
    assert "dp x tp" not in out


def test_dryrun_multichip_dp_x_tp_stage_passes_at_4(capsys):
    assert dryrun.dryrun_multichip(4, device="cpu", timeout=300) is True
    out = capsys.readouterr().out
    assert "[dryrun] stage dp: PASS" in out and "[dryrun] stage dp x tp: PASS" in out
    assert "data 2 x model 2" in out
    tp = [line for line in out.splitlines() if line.startswith("[dryrun] stage dp x tp:")]
    assert sum("step ok" in line for line in tp) == 2
    assert all("whole leaves equal True" in line and "slices equal across data groups True"
               in line for line in tp if "step ok" in line)
