"""The port's ``make_train_step`` with frozen masks on each new family's
stacked leaves vs ``repro.train.trainer.make_train_step`` (jitted), at the
reference's ``reduced_config`` sizes with its weights carried across: two
steps from the same state at 1 and 2 micro-batches.

The masks (``tests/_train_families.py`` ``MASKED``) are
``block_aware_prune``'s, one per 2-D slice of the routed experts (L, E, K,
N), the mLSTM projections (L, 7, K, N), the Mamba2 output projection and
the tied shared block's MLP, and the frontends' MLPs.  AdamW takes its
sliced path on every leaf (``UPDATE_CHUNK`` set below the smallest leaf),
so the slices are held against the reference too.

Loss, gradient norm and learning rate within f32 ``rtol=1e-5, atol=1e-6``
(xlstm-1.3b ``rtol=5e-5``); both moments leaf by leaf as in
``test_torch_train_families.py`` (xlstm-1.3b's f32 leaves within 5e-5 of
the leaf's largest value, the leaves of bf16 parameters within one bf16
step); the
parameters the same, but for AdamW's amplified rounding where a gradient
lies near zero: at most 1 in 1,000 f32 elements beyond the tolerance, each
by at most lr / 4 a step (measured: 44 of 327,424 by 0.11 lr at most,
``tests/_train_families.py``); pruned entries exactly zero, kept entries
trained.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _train_families import (  # noqa: E402,F401
    ARCHS, MASKED, TOL, XLSTM_REL, assert_leaves_close, assert_params_close,
    batch, get, mask_trees, np32, one_thread, pair, stacked_masks)
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer as ttr  # noqa: E402

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_masked_train_step_matches_reference(arch, n_micro, monkeypatch):
    monkeypatch.setattr(topt, "UPDATE_CHUNK", 999)
    jcfg, tcfg, jp, tp = pair(arch)
    masks_np = stacked_masks(tp, MASKED[tcfg.family])
    jmasks, tmasks = mask_trees(jp, masks_np)
    jstep = jax.jit(jtr.make_train_step(jcfg, jopt.AdamWConfig(**OPT),
                                        n_micro, jmasks))
    tstep = ttr.make_train_step(tcfg, topt.AdamWConfig(**OPT), n_micro,
                                tmasks)
    jst = jopt.adamw_init(jp, jopt.AdamWConfig(**OPT))
    tst = topt.adamw_init(tp, topt.AdamWConfig(**OPT))
    scalar = dict(TOL, rtol=XLSTM_REL) if arch == "xlstm-1.3b" else TOL
    for step in range(2):
        jb, tb = batch(tcfg, 4, 32, step)
        jp, jst, jmet = jstep(jp, jst, jb)
        tp, tst, tmet = tstep(tp, tst, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       **scalar, err_msg=f"step {step} {k}")
    assert_params_close(arch, tp, jp, OPT["lr"], 2)
    assert_leaves_close(arch, tst["m"], jst["m"], "m", like=tp)
    assert_leaves_close(arch, tst["v"], jst["v"], "v", like=tp)
    assert int(tst["step"]) == int(jst["step"]) == 2
    for path, m in masks_np.items():
        w = np32(get(tp, path))
        assert w.shape == m.shape and w.ndim >= 2
        assert np.all(w[~m] == 0), "/".join(path)
        assert np.all(w[m] != 0), "/".join(path)
