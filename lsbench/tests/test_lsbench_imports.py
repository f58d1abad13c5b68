"""Nothing of the JAX side is loaded by the harness, its reference or a
whole tiny run: the check compares top-level module names whole."""

import subprocess
import sys

from lsbench.run import FORBIDDEN, forbidden_modules
from lsbench.tests.conftest import BENCH, DATA, ROOT


def test_the_check_compares_whole_names(monkeypatch):
    import types

    assert "latentsync_tpu_torch" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "latentsync_tpu", types.ModuleType("latentsync_tpu"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("jaxlib.xla"))
    assert forbidden_modules() == ["jaxlib", "latentsync_tpu"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "latentsync_tpu"}


def test_a_tiny_run_and_its_reference_load_no_jax():
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from lsbench.run import run, forbidden_modules\n"
        "import lsbench.control, lsbench.check, lsbench.counts.schedule\n"
        f"r = run('tiny.prod', 99, 1.0, True, device='cpu', bench_path={BENCH!r}, "
        f"traffic_dir={DATA!r})\n"
        "print('FOUND', forbidden_modules(), r['correct'])\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FOUND [] True" in out.stdout, out.stdout[-2000:]
