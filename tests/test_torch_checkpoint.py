"""Port checkpointer and fault-tolerant runner, and checkpoints crossing
between the two packages.

Restored values must equal what was saved bit for bit (bf16 leaves are
stored widened to f32, which holds every bf16 value exactly); a checkpoint
written by ``repro`` restores in ``repro_torch`` and the other way round,
with the same keys, shapes, dtypes and bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _train_families import one_thread  # noqa: E402,F401
from repro.train.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro_torch.train.checkpoint import Checkpointer  # noqa: E402
from repro_torch.train.runtime import RunnerConfig, TrainRunner  # noqa: E402


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 4)).astype(np.float32),
            "b": rng.normal(size=(4,)).astype(np.float32),
            "w_qp": rng.integers(0, 256, size=(2, 4)).astype(np.uint8),
            "m": rng.normal(size=(4, 4)).astype(np.float32)}


def _torch_state(a):
    return {
        "params": {"w": torch.from_numpy(a["w"]),
                   "b": torch.from_numpy(a["b"]).to(torch.bfloat16),
                   "lin": {"w_qp": torch.from_numpy(a["w_qp"])}},
        "opt": {"m": {"w": torch.from_numpy(a["m"])},
                "step": torch.tensor(3, dtype=torch.int32)},
    }


def _jax_state(a):
    return {
        "params": {"w": jnp.asarray(a["w"]),
                   "b": jnp.asarray(a["b"], jnp.bfloat16),
                   "lin": {"w_qp": jnp.asarray(a["w_qp"])}},
        "opt": {"m": {"w": jnp.asarray(a["m"])},
                "step": jnp.asarray(3, jnp.int32)},
    }


def _bits(t):
    """Raw bytes of a tensor or array (bf16 through its int16 view)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().tobytes(), "bfloat16"
        return t.numpy().tobytes(), str(t.numpy().dtype)
    a = np.asarray(t)
    return a.tobytes(), str(a.dtype)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    s = _torch_state(_arrays())
    ck.save(7, s)
    out, manifest = ck.restore(s)
    assert manifest["step"] == 7
    for (p, a), (_, b) in zip(_leaves(out), _leaves(s)):
        assert a.dtype == b.dtype, p
        assert _bits(a) == _bits(b), p


def test_torn_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _torch_state(_arrays()))
    torn = tmp_path / "step_000000002"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert ck.latest_step() == 1


def test_async_save_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    s = _torch_state(_arrays())
    for step in (1, 2, 3, 4):
        ck.save_async(step, s)
    ck.wait()
    assert ck.all_steps() == [3, 4]


def test_async_save_snapshots_the_state(tmp_path):
    ck = Checkpointer(str(tmp_path))
    s = _torch_state(_arrays())
    want = s["params"]["w"].clone()
    ck.save_async(1, s)
    s["params"]["w"].add_(1.0)          # the caller moves on
    ck.wait()
    out, _ = ck.restore(_torch_state(_arrays(1)))
    torch.testing.assert_close(out["params"]["w"], want, rtol=0, atol=0)


def test_restore_latest_of_many(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=5)
    s = _torch_state(_arrays())
    for step in (5, 9, 12):
        ck.save(step, s)
    _, manifest = ck.restore(s)
    assert manifest["step"] == 12
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "none")).restore(s)


def test_container_leaf_is_never_widened(tmp_path):
    s = {"lin": {"w_qp": torch.zeros((2, 2), dtype=torch.bfloat16)}}
    with pytest.raises(TypeError, match="container"):
        Checkpointer(str(tmp_path)).save(1, s)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    a = _arrays(3)
    JCheckpointer(str(tmp_path)).save(4, _jax_state(a), extra={"k": 1})
    template = _torch_state(_arrays(9))
    out, manifest = Checkpointer(str(tmp_path)).restore(template)
    assert manifest["step"] == 4 and manifest["k"] == 1
    want = _torch_state(a)
    for (p, got), (_, w) in zip(_leaves(out), _leaves(want)):
        assert got.dtype == w.dtype, p
        assert _bits(got) == _bits(w), p


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    a = _arrays(4)
    Checkpointer(str(tmp_path)).save(6, _torch_state(a), extra={"k": 2})
    out, manifest = JCheckpointer(str(tmp_path)).restore(
        _jax_state(_arrays(8)))
    assert manifest["step"] == 6 and manifest["k"] == 2
    want = _jax_state(a)
    for (p, got), (_, w) in zip(_leaves(out), _leaves(want)):
        assert _bits(got) == _bits(w), p


def test_both_packages_write_the_same_files(tmp_path):
    a = _arrays(5)
    JCheckpointer(str(tmp_path / "j")).save(2, _jax_state(a))
    Checkpointer(str(tmp_path / "t")).save(2, _torch_state(a))
    zj = np.load(tmp_path / "j" / "step_000000002" / "host_0.npz")
    zt = np.load(tmp_path / "t" / "step_000000002" / "host_0.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype, k
        assert zj[k].tobytes() == zt[k].tobytes(), k
    mj = (tmp_path / "j" / "step_000000002" / "manifest.json").read_text()
    mt = (tmp_path / "t" / "step_000000002" / "manifest.json").read_text()
    assert mj == mt


def test_runner_trains_and_checkpoints(tmp_path):
    cfg = RunnerConfig(total_steps=40, ckpt_every=10, ckpt_dir=str(tmp_path),
                       log_every=100)

    def train_step(params, opt, batch):
        x = params["x"]
        x = x - 0.1 * 2 * (x - batch["t"])
        return {"x": x}, opt, {"loss": ((x - batch["t"]) ** 2).sum()}

    runner = TrainRunner(train_step, lambda step: {"t": torch.full((3,), 2.0)},
                         cfg)
    params, _ = runner.run({"x": torch.zeros(3)}, {})
    assert float((params["x"] - 2.0).abs().max()) < 0.1
    assert runner.ckpt.all_steps() == [20, 30, 40]
    assert len(runner.metrics_log) == 40
    assert all(m["step_s"] >= 0 for m in runner.metrics_log)


def test_runner_rolls_back_on_injected_failure(tmp_path):
    """Failure path: step fails -> restore last good checkpoint."""
    cfg = RunnerConfig(total_steps=6, ckpt_every=2, ckpt_dir=str(tmp_path),
                       max_retries=0, log_every=100)

    def train_step(params, opt, batch):
        return ({"x": params["x"] + 1.0}, opt, {"loss": torch.tensor(0.0)})

    fails = {"armed": True}

    def injector(step):
        if step == 4 and fails["armed"]:
            fails["armed"] = False
            raise RuntimeError("simulated node failure")

    runner = TrainRunner(train_step, lambda s: {}, cfg)
    runner.fault_injector = injector
    params, _ = runner.run({"x": torch.zeros(())}, {})
    # all 6 increments applied despite the mid-run failure + rollback
    assert float(params["x"]) == 6.0


def test_runner_resumes_from_the_latest_checkpoint(tmp_path):
    step_fn = lambda p, o, b: ({"x": p["x"] + 1.0}, o,
                               {"loss": torch.tensor(0.0)})
    TrainRunner(step_fn, lambda s: {}, RunnerConfig(
        total_steps=4, ckpt_every=2, ckpt_dir=str(tmp_path))).run(
        {"x": torch.zeros(())}, {})
    runner = TrainRunner(step_fn, lambda s: {}, RunnerConfig(
        total_steps=7, ckpt_every=2, ckpt_dir=str(tmp_path)))
    params, _ = runner.run({"x": torch.zeros(())}, {})
    assert float(params["x"]) == 7.0 and len(runner.metrics_log) == 3


def test_runner_without_checkpoints(tmp_path):
    cfg = RunnerConfig(total_steps=3, ckpt_every=0,
                       ckpt_dir=str(tmp_path / "ck"), max_retries=0)
    step_fn = lambda p, o, b: ({"x": p["x"] + 1.0}, o,
                               {"loss": torch.tensor(0.0)})
    runner = TrainRunner(step_fn, lambda s: {}, cfg)
    params, _ = runner.run({"x": torch.zeros(())}, {})
    assert float(params["x"]) == 3.0
    assert not (tmp_path / "ck").exists()
    runner.fault_injector = lambda step: (_ for _ in ()).throw(
        RuntimeError("boom"))
    cfg.total_steps = 4
    with pytest.raises(RuntimeError, match="no checkpoint"):
        runner.run(params, {}, start_step=3)


def test_runner_deadline_trips_and_retries(tmp_path):
    import time as _time

    calls = {"n": 0}

    def slow_once(params, opt, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            _time.sleep(0.3)
        return params, opt, {"loss": torch.tensor(0.0)}

    cfg = RunnerConfig(total_steps=1, ckpt_every=0, step_deadline_s=0.2,
                       max_retries=1, ckpt_dir=str(tmp_path))
    runner = TrainRunner(slow_once, lambda s: {}, cfg)
    runner.run({"x": torch.zeros(())}, {})
    assert calls["n"] == 2 and len(runner.metrics_log) == 1


# ------------------------------------------- the new families' train state


def _family_run(arch, ckpt_dir, params, total_steps=4):
    """``TrainRunner`` over the reduced config's masked train step (2
    micro-batches; ``block_aware_prune`` masks on one stacked leaf of the
    family), a checkpoint every 2 steps."""
    from repro_torch.configs import reduced_config
    from repro_torch.core.pruning import block_aware_prune
    from repro_torch.data.synthetic import token_batch
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import make_train_step

    cfg = reduced_config(arch)
    path = {"moe": ("moe", "eg"), "ssm": ("mlstm", "wq"),
            "hybrid": ("mamba", "wout")}[cfg.family]
    w = params["blocks"][path[0]][path[1]]["w"]
    flat = w.float().reshape(-1, *w.shape[-2:]).numpy()
    mask = torch.from_numpy(np.stack([block_aware_prune(
        s, (16, 16), block_density=0.5, in_block_density=0.5)
        for s in flat]).reshape(w.shape))
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=total_steps)
    step = make_train_step(cfg, opt_cfg, 2,
                           {"blocks": {path[0]: {path[1]: {"w": mask}}}})

    def data_fn(i):
        toks, labels = token_batch(i, 4, 16, cfg.vocab)
        return {"tokens": torch.from_numpy(toks),
                "labels": torch.from_numpy(labels)}

    runner = TrainRunner(step, data_fn, RunnerConfig(
        total_steps=total_steps, ckpt_every=2, ckpt_dir=str(ckpt_dir),
        log_every=100))
    out = runner.run(params, adamw_init(params, opt_cfg))
    return runner, out, (path, mask)


def _assert_bitwise(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert _bits(x) == _bits(y), p


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "xlstm-1.3b",
                                  "zamba2-2.7b"])
def test_new_family_train_state_round_trips_and_resumes(arch, tmp_path):
    """The nested params (stacked experts, the mLSTM / sLSTM stacks, the
    tied ``shared_attn``; f32 weights, bf16 gains) and their AdamW state
    restore bit for bit, and a runner resumed from step 2 of a copy
    continues with the same losses, parameters and moments."""
    import shutil

    from repro_torch.configs import reduced_config
    from repro_torch.models.model import init_params
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    init = lambda: init_params(reduced_config(arch), seed=0, device="cpu")
    ra, (pa, oa), (path, mask) = _family_run(arch, tmp_path / "a", init())
    assert ra.ckpt.all_steps() == [2, 4]
    template = {"params": init(),
                "opt": adamw_init(init(), AdamWConfig())}
    state, manifest = ra.ckpt.restore(template)
    assert manifest["step"] == 4
    _assert_bitwise(state, {"params": pa, "opt": oa})
    w = pa["blocks"][path[0]][path[1]]["w"]
    assert bool((w[~mask] == 0).all())

    shutil.copytree(tmp_path / "a" / "step_000000002",
                    tmp_path / "b" / "step_000000002")
    rb, (pb, ob), _ = _family_run(arch, tmp_path / "b", init())
    assert [m["loss"] for m in rb.metrics_log] == [
        m["loss"] for m in ra.metrics_log[2:]]
    _assert_bitwise({"params": pb, "opt": ob}, {"params": pa, "opt": oa})


def test_runner_holds_only_the_current_state(tmp_path):
    """A caller that hands over its last references lets the first state
    go after the first step: a step's peak holds two states, not three."""
    import weakref

    seen = []

    def step_fn(p, o, b):
        seen.append(first() is not None)
        return {"x": p["x"] + 1.0}, o, {"loss": torch.tensor(0.0)}

    box = {"params": {"x": torch.zeros(3)}, "opt": {}}
    first = weakref.ref(box["params"]["x"])
    runner = TrainRunner(step_fn, lambda s: {}, RunnerConfig(
        total_steps=3, ckpt_every=0, ckpt_dir=str(tmp_path)))
    params, _ = runner.run(box.pop("params"), box.pop("opt"))
    assert seen == [True, False, False]
    assert float(params["x"][0]) == 3.0
