"""The port stands without JAX: it imports and runs a forward with ``jax`` unimportable."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent.parent

SCRIPT = """
import sys
for name in ("jax", "jaxlib", "flax", "optax", "blvm_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import pkgutil, importlib
import numpy as np, torch
import blvm_tpu_torch
for mod in pkgutil.walk_packages(blvm_tpu_torch.__path__, "blvm_tpu_torch."):
    importlib.import_module(mod.name)
from blvm_tpu_torch import weights
from blvm_tpu_torch.models import WaveNet
model = WaveNet(n_layers=2, n_stacks=1, res_channels=8, num_mix=2, num_bins=256)
weights.load_jax_params(model, weights.random_jax_params(model, 0))
x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 20)).astype(np.float32))
with torch.inference_mode():
    loss, mets, out = model(x, torch.tensor([20, 13]))
assert torch.isfinite(loss) and out.log_prob_twise.shape == (2, 20)
loaded = [m for m in ("jax", "flax", "optax", "blvm_tpu") if sys.modules.get(m) is not None]
assert not loaded, loaded
print("ok", float(loss))
"""


def test_port_imports_and_runs_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok ")


def test_port_sources_never_name_jax():
    package = REPO / "blvm_tpu_torch"
    for path in package.rglob("*.py"):
        if "_build" in path.relative_to(package).parts:  # build output, not the package's sources
            continue
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                assert "jax" not in stripped and "flax" not in stripped and "optax" not in stripped, (path, line)
                assert not stripped.startswith(("import blvm_tpu ", "from blvm_tpu ", "from blvm_tpu.")), (path, line)
