"""chip_smoke.py: its device guard. Its float64 matcher reference is
tested in test_matching_reference.py."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke


@pytest.mark.parametrize("argv", [[], ["--cards", "4"]])
def test_stops_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert "no GPU" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out


def test_fails_without_the_package(tmp_path):
    """Alone in a directory, the script cannot import the program: it
    exits non-zero and prints no result line."""
    shutil.copy(chip_smoke.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

