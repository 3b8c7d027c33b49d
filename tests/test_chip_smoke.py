"""chip_smoke.py's contract pieces that run without a GPU."""

import json
import os
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as mod
    finally:
        sys.path.remove(REPO)
    return mod


def test_device_check_refuses_cpu(chip_smoke):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device(jax)


def test_contract_line_keys(chip_smoke):
    devs = jax.devices()[:1]
    line = chip_smoke.contract_line(devs)
    assert "\n" not in line
    payload = json.loads(line)
    assert payload == {"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": 1}}


def test_script_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
