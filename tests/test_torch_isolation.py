"""The PyTorch port stands alone: it imports neither JAX nor any module
of the reference package `repro`, at run time (a subprocess that
serves a request on the CPU through each of the chunked, whole-prompt
paged and dense engines, and one of the ssm family (reduced
falcon-mamba, through the dense fallback), then runs two steps of the
compiled AMR engine, ends with neither in `sys.modules`) and in its
sources (`src/repro_torch/`, the AMR and stencil modules among them,
and `chip_smoke.py`)."""

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

PROBE = """
import sys
import numpy as np
import repro_torch.configs as configs
from repro_torch.device import make_generator
from repro_torch.models import transformer as T
from repro_torch.serving.engine import Request, make_engine
import repro_torch.launch.serve

cfg = configs.get_reduced("yi-6b")
params = T.init_params(make_generator(0, "cpu"), cfg)
eng = make_engine(params, cfg, slots=2, max_len=64, page_size=8,
                  chunk_size=16, prefix_cache_compute=True, device="cpu")
fut = eng.submit(Request(0, np.arange(20, dtype=np.int32),
                         max_new_tokens=3))
eng.run_to_completion()
assert len(fut.get().tokens) == 3
for engine in ("paged", "dense"):
    eng = make_engine(params, cfg, engine=engine, slots=2, max_len=64,
                      prefill_buckets=(32,), device="cpu")
    fut = eng.submit(Request(1, np.arange(20, dtype=np.int32),
                             max_new_tokens=3))
    eng.run_to_completion()
    assert len(fut.get().tokens) == 3, engine
cfg = configs.get_reduced("falcon-mamba-7b")
params = T.init_params(make_generator(0, "cpu"), cfg)
eng = make_engine(params, cfg, slots=2, max_len=64, prefill_buckets=(32,),
                  device="cpu")
assert type(eng).__name__ == "DenseServingEngine"
fut = eng.submit(Request(2, np.arange(20, dtype=np.int32),
                         max_new_tokens=3))
eng.run_to_completion()
assert len(fut.get().tokens) == 3, cfg.name
from repro_torch.amr import compiled, wave
step, _, init, to_g, _, info = compiled.make_uniform_step(
    wave.WaveProblem(rmax=20.0, amplitude=0.005),
    compiled.CompiledAMRConfig(grain=32, slots=4, n_steps=2), 2,
    device="cpu")
assert bool(wave.linf(to_g(step(init()))) > 0)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
"""


def test_serving_on_cpu_loads_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.M)


def test_sources_import_neither_jax_nor_the_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    rel = {str(f.relative_to(SRC / "repro_torch")) for f in files[:-1]}
    assert {"amr/wave.py", "amr/compiled.py", "kernels/stencil/ref.py",
            "kernels/stencil/stencil.py", "kernels/stencil/ops.py"} <= rel
    for f in files:
        text = f.read_text()
        hits = FORBIDDEN.findall(text)
        assert not hits, f"{f.relative_to(ROOT)} imports {hits}"
