"""Race check of the port's native data loader under ThreadSanitizer
(tools/run_tsan_check_torch.py: a TSan build of
gan_class_transfer2_tpu_torch/data/native/dataloader.cc driven through its
four cases). Opt-in, as tests/test_tsan.py is: RUN_SLOW=1."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")


def test_port_native_loader_has_no_data_races():
    if os.environ.get("RUN_SLOW") != "1":
        pytest.skip("TSan build of the port's loader; RUN_SLOW=1")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, os.path.join(repo, "tools", "run_tsan_check_torch.py")],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-1500:]
    for case in range(1, 5):
        assert f"case {case}:" in proc.stdout
    assert "TSAN: no data races" in proc.stdout
