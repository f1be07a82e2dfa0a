"""The port's launch modules against the JAX package's, on the CPU: the
shape presets and input specs, the watchdog, and the training driver.

Shapes: for every config and preset, ``cell_supported`` gives the JAX
package's string; the train and prefill specs (``sig_loss`` off and on) and
the decode specs have the JAX shapes, each dtype equal or mapped as
``repro_torch.launch.shapes`` states (int32 -> int64); ``microbatch_policy``
gives the JAX integers over a grid; ``cache_shape_for`` on the reduced
configs equals ``jax.eval_shape`` of the JAX ``cache_init``, leaf by leaf.

Watchdog: ``scan`` skips a torn heartbeat; ``main`` reports a straggler
and a hang and exits 1, and with ``--restart-cmd`` starts the command
once per allowed restart.

Driver (``--device cpu --reduced --sig-loss``): its schedule is the JAX
driver's; 4 steps straight and a resume at step 2 to step 4 leave the same
step-4 checkpoint bit for bit; a subprocess that gets SIGTERM once its
heartbeat reports step >= 1 exits 0 with its checkpoint at the step it
reached, and the resumed run's final checkpoint equals an uninterrupted
run's bit for bit; ``--mesh pod`` is refused, and the default device
raises without CUDA.  Every subprocess has its own timeout, and the
heartbeat is polled against a deadline.
"""

import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import shapes as jshapes
from repro.models import build_model as jbuild_model
from repro.models import get_config as jget_config
from repro.optim.adamw import cosine_schedule as jcosine
from repro_torch.launch import shapes
from repro_torch.launch import train as drv
from repro_torch.launch import watchdog
from repro_torch.models import get_config, list_configs
from repro_torch.models.params import tree_items

jax.config.update("jax_platform_name", "cpu")

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = list_configs()
PRESETS = sorted({**shapes.SHAPES, **shapes.SIG_SHAPES})
#: the port's dtype for each JAX spec dtype (shapes.py's docstring)
DTYPE = {"int32": "int64", "bfloat16": "bfloat16", "float32": "float32"}


def spec_rows(tree):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tree_items(tree)}


def jax_rows(tree):
    return {k: (tuple(v.shape), DTYPE.get(str(v.dtype), str(v.dtype)))
            for k, v in tree_items(tree)}


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def test_presets_equal_jax():
    for table, jtable in ((shapes.SHAPES, jshapes.SHAPES),
                          (shapes.SIG_SHAPES, jshapes.SIG_SHAPES)):
        assert {k: tuple(vars(v).values()) for k, v in table.items()} == \
            {k: (v.name, v.kind, v.seq, v.batch) for k, v in jtable.items()}


@pytest.mark.parametrize("arch", CONFIGS)
def test_cells_and_specs_match_jax(arch):
    for sig_loss in (False, True):
        cfg, jcfg = (get_config(arch).replace(sig_loss=sig_loss),
                     jget_config(arch).replace(sig_loss=sig_loss))
        for name in PRESETS:
            shape = {**shapes.SHAPES, **shapes.SIG_SHAPES}[name]
            jshape = {**jshapes.SHAPES, **jshapes.SIG_SHAPES}[name]
            assert shapes.cell_supported(cfg, shape) == jshapes.cell_supported(jcfg, jshape)
            got = shapes.train_input_specs(cfg, shape)
            assert all(t.device.type == "meta" for _, t in tree_items(got))
            assert spec_rows(got) == jax_rows(jshapes.train_input_specs(jcfg, jshape))
            assert spec_rows(shapes.prefill_input_specs(cfg, shape)) == \
                jax_rows(jshapes.prefill_input_specs(jcfg, jshape))
            got = shapes.decode_input_specs(cfg, shape, {})
            want = jshapes.decode_input_specs(jcfg, jshape, {})
            assert got["caches"] == {}
            assert spec_rows({k: got[k] for k in ("tokens", "cur_len")}) == \
                jax_rows({k: want[k] for k in ("tokens", "cur_len")})


def policy(fn, *args):
    try:
        return fn(*args)
    except ZeroDivisionError:        # both packages, where shard does not divide gb
        return "ZeroDivisionError"


def test_microbatch_policy_matches_jax():
    for arch in CONFIGS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for gb in (1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 64, 100, 128, 256, 512, 1024):
            for shard in (1, 2, 3, 4, 8, 16, 32):
                assert policy(shapes.microbatch_policy, cfg, gb, shard) == \
                    policy(jshapes.microbatch_policy, jcfg, gb, shard), (arch, gb, shard)


@pytest.mark.parametrize("arch", [a for a in CONFIGS if a != "sigkernel-workload"])
def test_cache_shape_matches_jax_eval_shape(arch):
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    jmodel = jbuild_model(jcfg)
    for name in ("decode_32k", "long_500k"):
        shape = shapes.SHAPES[name]
        if shapes.cell_supported(cfg, shape) is not None:
            continue
        got = shapes.cache_shape_for(cfg, shape)
        assert all(t.device.type == "meta" for _, t in tree_items(got))
        want = jshapes.cache_shape_for(jmodel, jcfg, jshapes.SHAPES[name])
        assert spec_rows(got) == {k: (tuple(v.shape), str(v.dtype))
                                  for k, v in tree_items(want)}


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

def write_beat(path, step, age, process=0):
    with open(path, "w") as f:
        json.dump({"step": step, "time": time.time() - age, "process": process}, f)


def test_scan_skips_torn_heartbeats(tmp_path):
    write_beat(tmp_path / "hb_0.json", 4, 0.0)
    (tmp_path / "hb_1.json").write_text('{"step": 3, "ti')
    (tmp_path / "hb_2.json").write_text("")
    beats = watchdog.scan(str(tmp_path / "hb_*.json"))
    assert [b["step"] for b in beats] == [4]


def test_watchdog_reports_straggler_and_hang(tmp_path, capsys):
    write_beat(tmp_path / "hb_0.json", 10, 1000.0, process=0)
    write_beat(tmp_path / "hb_1.json", 2, 1000.0, process=1)
    with pytest.raises(SystemExit) as exit_:
        watchdog.main(["--pattern", str(tmp_path / "hb_*.json"), "--timeout", "1",
                       "--interval", "0.01"])
    assert exit_.value.code == 1
    out = capsys.readouterr().out
    assert "STRAGGLER proc 1 at step 2 (median 10)" in out
    assert "HANG detected (2 stale heartbeats)" in out


def test_watchdog_restarts_the_command_once(tmp_path, capsys):
    write_beat(tmp_path / "hb_0.json", 3, 1000.0)
    marker = tmp_path / "restarted"
    cmd = f"{sys.executable} -c \"open('{marker}', 'a').write('x')\""
    with pytest.raises(SystemExit) as exit_:
        watchdog.main(["--pattern", str(tmp_path / "hb_*.json"), "--timeout", "1",
                       "--interval", "0.01", "--restart-cmd", cmd, "--max-restarts", "1"])
    assert exit_.value.code == 1
    out = capsys.readouterr().out
    assert out.count("restart #") == 1 and out.count("HANG detected") == 2
    deadline = time.monotonic() + 60
    while not (marker.exists() and marker.read_text()) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert marker.read_text() == "x"


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

CMD = ["--device", "cpu", "--reduced", "--sig-loss", "--log-every", "1"]


@pytest.mark.parametrize("steps", [1, 4, 20, 99, 1000, 2500])
def test_schedule_is_the_jax_drivers(steps):
    """cosine_schedule(lr, min(100, steps // 10 + 1), steps), as
    src/repro/launch/train.py builds it, at every step."""
    port = drv.schedule(3e-4, steps)
    want = np.asarray(jcosine(3e-4, min(100, steps // 10 + 1), steps)(
        jnp.arange(steps + 6, dtype=jnp.int32)))
    got = np.array([port(s) for s in range(steps + 6)])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def read_checkpoint(directory, step):
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "proc_0.npz")) as data:
        arrays = [data[str(i)] for i in range(len(meta["names"]))]
    return meta, arrays


def assert_checkpoints_equal(a_dir, b_dir, step):
    (ma, xa), (mb, xb) = read_checkpoint(a_dir, step), read_checkpoint(b_dir, step)
    for key in ("step", "names", "shapes", "dtypes"):
        assert ma[key] == mb[key], key
    assert "1/count" in ma["names"] and "0/sig_proj" in ma["names"]
    for name, a, b in zip(ma["names"], xa, xb):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name


@pytest.fixture
def saves(monkeypatch):
    """The training driver's checkpoint saves, (step, blocking) each."""
    record = []

    class Recorded(drv.CheckpointManager):
        def save(self, step, tree, blocking=False):
            record.append((step, blocking))
            super().save(step, tree, blocking)

    monkeypatch.setattr(drv, "CheckpointManager", Recorded)
    return record


@pytest.fixture
def deterministic():
    """torch's deterministic algorithms for the test: on the CPU the
    embedding's backward (``table[tokens]``) sums a token's rows in thread
    order otherwise, so two runs of the same step differ in the last bits."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def test_resume_in_process_is_bit_for_bit(tmp_path, capsys, deterministic, saves):
    """Also: the final synchronous checkpoint at step 4 is the asynchronous
    save of step 4, waited for, not a second write of the same state."""
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    before = signal.getsignal(signal.SIGTERM)
    model, opt = drv.train(CMD + ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", straight])
    assert saves == [(2, False), (4, False)]
    assert signal.getsignal(signal.SIGTERM) is before
    out = capsys.readouterr().out
    assert re.search(r"^step     4  loss \d+\.\d{4}  gnorm \d+\.\d{3}  \d+ ms/step$", out, re.M)
    assert out.rstrip().endswith("done")
    assert opt.state["count"] == 4 and model.cfg.sig_loss
    os.makedirs(resumed)
    shutil.copytree(os.path.join(straight, "step_2"), os.path.join(resumed, "step_2"))
    drv.train(CMD + ["--steps", "4", "--ckpt-every", "2", "--ckpt-dir", resumed])
    out = capsys.readouterr().out
    assert out.startswith("resumed from step 2\n") and "step     3" in out
    assert signal.getsignal(signal.SIGTERM) is before
    assert_checkpoints_equal(straight, resumed, 4)


def test_final_checkpoint_is_written_where_no_save_holds_it(tmp_path, saves):
    drv.train(CMD + ["--steps", "3", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)])
    assert saves == [(2, False), (3, True)]
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]


def run_driver(args, env, timeout=240):
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *CMD, *args],
                          capture_output=True, text=True, cwd=ROOT, env=env, timeout=timeout)


def test_sigterm_checkpoints_and_resume_is_bit_for_bit(tmp_path):
    # one thread a run: the embedding's backward sums in a fixed order
    env = {**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"}
    ckpt, hb = str(tmp_path / "ckpt"), str(tmp_path / "hb.json")
    args = ["--steps", "8", "--ckpt-every", "2", "--ckpt-dir", ckpt, "--heartbeat", hb]
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *CMD, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=ROOT, env=env)
    try:
        deadline = time.monotonic() + 180
        while not any(b["step"] >= 1 for b in watchdog.scan(hb)):
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline, "no heartbeat at step >= 1"
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out + err
    assert "signal 15: writing preemption checkpoint" in out and "done" not in out, out
    (beat,) = watchdog.scan(hb)
    assert beat["process"] == 0
    reached = beat["step"] + 1
    assert 2 <= reached < 8, out
    assert max(int(n.split("_")[1]) for n in os.listdir(ckpt)) == reached
    assert not any(n.endswith(".tmp") for n in os.listdir(ckpt))

    resumed = run_driver(args, env)
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert resumed.stdout.startswith(f"resumed from step {reached}\n")
    assert resumed.stdout.rstrip().endswith("done")
    straight = run_driver(["--steps", "8", "--ckpt-every", "2", "--ckpt-dir",
                           str(tmp_path / "straight")], env)
    assert straight.returncode == 0, straight.stdout + straight.stderr
    assert_checkpoints_equal(ckpt, str(tmp_path / "straight"), 8)


def test_pod_meshes_are_refused():
    for mesh in ("pod", "multipod"):
        with pytest.raises(NotImplementedError, match="no counterpart"):
            drv.train(["--mesh", mesh, "--device", "cpu", "--reduced"])


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        drv.train(["--reduced", "--steps", "1"])
    assert signal.getsignal(signal.SIGTERM) is before
