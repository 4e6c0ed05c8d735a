"""The port's CLI runner and profiling helpers (tests/test_cli.py on
``tensorlink_tpu_torch.cli`` and ``tensorlink_tpu_torch.utils.profiling``).

One deliberate difference from the JAX runner: the JAX CLI degrades to
host capacity when its accelerator is dead (tests/test_cli.py:41); a
port worker whose config asks for the card on a host without one exits
at once with the device error instead, and with ``device: cpu`` it comes
up. The subprocess hides any card (``CUDA_VISIBLE_DEVICES=""``), so the
rule is held on any host."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch


def _config(tmp_path, **extra):
    cfg = {
        "role": "worker",
        "mode": "local",
        "key_dir": str(tmp_path / "keys"),
        "log_dir": str(tmp_path / "logs"),
        "env_file": str(tmp_path / ".env"),
        **extra,
    }
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    return path


def _run(cfg_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "tensorlink_tpu_torch.cli", "-c",
         str(cfg_path), "--ui-interval", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("the node did not stop on SIGTERM")


def test_cli_starts_worker_and_reports(tmp_path):
    """``python -m tensorlink_tpu_torch.cli -c config.json`` prints the
    node's JSON line and stops cleanly (status 0) on SIGTERM."""
    proc = _run(_config(tmp_path, ml={"device": "cpu"}))
    try:
        info = json.loads(proc.stdout.readline())
        assert info["role"] == "worker" and info["port"] > 0
        assert len(info["id"]) > 0
    finally:
        rc = _stop(proc)
    assert rc == 0, proc.stderr.read()


@pytest.mark.parametrize("device", ["card", "cpu"])
def test_cli_worker_device_rule(tmp_path, device):
    """Replaces tests/test_cli.py:41 with the port's rule: with no card,
    a worker config that asks for the card (no ``ml.device``) exits with
    ``resolve_device``'s error within 60 s and prints no node line; with
    ``device: cpu`` the worker comes up."""
    extra = {"ml": {"device": "cpu"}} if device == "cpu" else {}
    proc = _run(_config(tmp_path, **extra))
    try:
        t0 = time.monotonic()
        if device == "card":
            out, err = proc.communicate(timeout=60)
            assert time.monotonic() - t0 < 60
            assert proc.returncode == 1, (proc.returncode, err)
            assert out == ""
            assert "no CUDA device is available" in err
            return
        info = json.loads(proc.stdout.readline())
        assert time.monotonic() - t0 < 60
        assert info["role"] == "worker" and info["port"] > 0
    finally:
        if proc.poll() is None:
            _stop(proc)


def test_status_report_format(tmp_path):
    from tensorlink_tpu_torch.cli import status_report
    from tensorlink_tpu_torch.core.config import MLConfig, WorkerConfig
    from tensorlink_tpu_torch.nodes.runners import WorkerNode

    node = WorkerNode(WorkerConfig(
        local_test=True, key_dir=str(tmp_path / "k"),
        log_dir=str(tmp_path / "l"), env_file=str(tmp_path / ".e"),
        ml=MLConfig(device="cpu"))).start()
    try:
        out = status_report(node)
        assert "worker" in out and "peers (0)" in out
    finally:
        node.stop()


def test_step_timer_and_device_memory():
    from tensorlink_tpu_torch.utils.profiling import StepTimer, device_memory

    t = StepTimer(warmup=1)
    for _ in range(3):
        with t.step():
            time.sleep(0.01)
    assert len(t.times) == 2 and t.mean >= 0.01
    assert t.p50 >= 0.01

    mem = device_memory()
    assert mem
    if not torch.cuda.is_available():
        assert mem == [{"device": "cpu", "platform": "cpu",
                        "bytes_in_use": None, "peak_bytes_in_use": None,
                        "bytes_limit": None}]
    else:
        assert all(m["platform"] == "gpu" and m["bytes_limit"] > 0
                   for m in mem)


def test_profiler_trace_writes(tmp_path):
    """A CPU tensor op under ``trace``, inside an ``annotate`` region:
    the Chrome trace in ``log_dir`` is non-empty and names the region and
    the op."""
    from tensorlink_tpu_torch.utils.profiling import annotate, trace

    with trace(tmp_path / "tr") as prof:
        with annotate("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "tr" / "trace.json"
    assert path.stat().st_size > 0
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "matmul" in names
    assert any(str(n).startswith("aten::mm") for n in names)
    assert any(e.key == "matmul" for e in prof.key_averages())
