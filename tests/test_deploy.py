"""Deployment supervisor (deploy/detect.sh): shutdown semantics."""

import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "deploy", "detect.sh")


@pytest.mark.skipif(not os.path.exists("/bin/bash"), reason="needs bash")
def test_sigterm_shuts_down_promptly(tmp_path):
    """systemctl stop sends TERM: cleanup's `kill 0` re-delivers TERM
    to the supervisor shell itself, which must NOT re-enter the trap
    in a loop (the old livelock held the unit until systemd's
    TimeoutStopSec SIGKILL, ~90 s per restart)."""
    cfg = tmp_path / "detector.cfg"
    cfg.write_text("block_size: 2048\nblock_history: 600\n"
                   "carrier_window: 7 - 110\n")
    env = dict(
        os.environ,
        CONFIG=str(cfg),
        OUTPUT=str(tmp_path / "rx.toad"),
        FIFO=str(tmp_path / "capture.fifo"),
        CAPTURE_CMD="sleep 300",
        JAX_PLATFORMS="cpu",
        PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
        PATH=os.environ["PATH"],
    )
    # New session: the script's `kill 0` must signal ITS process
    # group, not pytest's.
    proc = subprocess.Popen(
        ["/bin/bash", SCRIPT], env=env, start_new_session=True,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    time.sleep(2.0)  # let it reach the supervised stage
    os.kill(proc.pid, signal.SIGTERM)
    t0 = time.time()
    try:
        proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        pytest.fail("detect.sh did not exit within 20 s of SIGTERM "
                    "(trap re-entry livelock)")
    elapsed = time.time() - t0
    assert elapsed < 15, "shutdown took {:.1f} s".format(elapsed)
    assert not (tmp_path / "capture.fifo").exists()
