"""The port stands alone: it imports with JAX, ``ml_dtypes``, orbax,
triton and the JAX package blocked, imports none of them anywhere, builds nothing at
import, and its entry points refuse to run on the CPU unasked."""

import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from tf_operator_tpu_torch.testing.threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "tf_operator_tpu_torch"
CSRC = PORT / "ops" / "csrc"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "ml_dtypes", "tf_operator_tpu"}
MODULES = [
    "tf_operator_tpu_torch",
    "tf_operator_tpu_torch.device",
    "tf_operator_tpu_torch.metrics",
    "tf_operator_tpu_torch.ops.build",
    "tf_operator_tpu_torch.ops.roofline",
    "tf_operator_tpu_torch.ops.rope",
    "tf_operator_tpu_torch.ops.flash",
    "tf_operator_tpu_torch.ops.attention",
    "tf_operator_tpu_torch.ops.ring_attention",
    "tf_operator_tpu_torch.ops.cross_entropy",
    "tf_operator_tpu_torch.ops.remat",
    "tf_operator_tpu_torch.models.llama",
    "tf_operator_tpu_torch.models.bert",
    "tf_operator_tpu_torch.models.resnet",
    "tf_operator_tpu_torch.models.mnist",
    "tf_operator_tpu_torch.models.convert",
    "tf_operator_tpu_torch.train.data",
    "tf_operator_tpu_torch.train.train_step",
    "tf_operator_tpu_torch.train.llama_train",
    "tf_operator_tpu_torch.train.bert_train",
    "tf_operator_tpu_torch.train.resnet_train",
    "tf_operator_tpu_torch.train.mnist_train",
    "tf_operator_tpu_torch.train.checkpoint",
    "tf_operator_tpu_torch.train.restore",
    "tf_operator_tpu_torch.native.build",
    "tf_operator_tpu_torch.runtime.gpu_init",
    "tf_operator_tpu_torch.runtime.launch",
    "tf_operator_tpu_torch.api.gpu",
    "tf_operator_tpu_torch.runtime.heartbeat",
    "tf_operator_tpu_torch.runtime.shard_server",
    "tf_operator_tpu_torch.runtime.profiling",
    "tf_operator_tpu_torch.cluster.kube",
    "tf_operator_tpu_torch.parallel.mesh",
    "tf_operator_tpu_torch.parallel.sharding",
    "tf_operator_tpu_torch.parallel.experts",
    "tf_operator_tpu_torch.parallel.collectives",
    "tf_operator_tpu_torch.parallel.pipeline",
    "tf_operator_tpu_torch.testing.rendezvous_workload",
    "tf_operator_tpu_torch.testing.parity_workload",
    "tf_operator_tpu_torch.testing.restore_faults",
    "chip_smoke",
]


def run_python(code, cwd=ROOT, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_imports_with_jax_and_the_jax_package_blocked():
    # triton too: no module builds or imports a kernel at import.
    blocked = "; ".join(f"sys.modules[{name!r}] = None"
                        for name in sorted(FORBIDDEN | {"triton"}))
    code = (
        f"import sys; {blocked}\n"
        f"import importlib\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "import runpy; runpy.run_path('scripts/multicard_smoke.py', run_name='multicard_smoke')\n"
        "runpy.run_path('scripts/measure_recovery_torch.py', run_name='measure_recovery_torch')\n"
        "from tf_operator_tpu_torch.ops import build\n"
        "assert build._lib is None, 'a kernel library was loaded at import'\n"
        "print('imported')\n"
    )
    proc = run_python(code)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_forbidden_import_anywhere_in_the_port():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "scripts" / "multicard_smoke.py",
                                          ROOT / "scripts" / "measure_recovery_torch.py"]
    assert len(files) > 10
    for path in files:
        bad = FORBIDDEN.intersection(_imported_roots(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_entry_point_refuses_the_cpu_unasked():
    proc = run_python(
        "import sys; from tf_operator_tpu_torch.train import llama_train; "
        "sys.exit(llama_train.main(['--steps', '1']))"
    )
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_no_silent_fallback_off_the_cpu():
    """Plain versions serve CPU tensors only: any other device gets the
    kernel (CUDA) or an error, never the plain path."""
    import torch

    from tf_operator_tpu_torch.ops import flash, rope

    x = torch.empty(1, 4, 2, 8, device="meta")
    table = torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rope.rope(x, table, table)
    with pytest.raises(ValueError, match="unsupported device"):
        flash.flash_attention(x, x, x)
    # The kernel wrappers themselves refuse anything but a CUDA tensor.
    cpu = torch.zeros(1, 64, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash.flash_forward_cuda(cpu, cpu, cpu)
    with pytest.raises(ValueError, match="CUDA"):
        rope.rope_cuda(cpu, torch.zeros(64, 64), torch.zeros(64, 64))


def test_kernel_build_raises_without_nvcc(monkeypatch):
    from tf_operator_tpu_torch.ops import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    proc = run_python("import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env={**os.environ, "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_sources_exist():
    import chip_smoke

    for name, (source, replaces) in chip_smoke.SOURCES.items():
        assert (ROOT / source).is_file(), f"{name}: {source} is missing"
        path, line = replaces.rsplit(":", 1)
        assert int(line) <= len((ROOT / path).read_text().splitlines()), replaces


def _extern_c_functions(text):
    """Names of the functions defined with C linkage: `extern "C" T f(...)`
    or inside an `extern "C" { ... }` block (its braces matched)."""
    names = set(re.findall(r'extern "C" [^{(;]*?\b(\w+)\(', text))
    for m in re.finditer(r'extern "C" \{', text):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        block = text[m.end():i]
        names.update(re.findall(r"^[A-Za-z][^(;=]*?\b(\w+)\(", block, re.M))
    return names


def test_every_signature_is_defined_in_csrc():
    """Each entry point build.load binds is a C function of some .cu file."""
    from tf_operator_tpu_torch.ops import build

    defined = set()
    for src in CSRC.glob("*.cu"):
        defined |= _extern_c_functions(src.read_text())
    missing = (set(build._SIGNATURES) | {"tk_error_string"}) - defined
    assert not missing, f"no extern \"C\" definition of {sorted(missing)}"


def test_every_csrc_include_exists():
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    assert sources
    for src in sources:
        for name in re.findall(r'^#include "([^"]+)"', src.read_text(), re.M):
            assert (CSRC / name).is_file(), f"{src.name} includes missing {name}"
        assert "<mma.h>" not in src.read_text(), f"{src.name} still uses WMMA"


def test_multicard_smoke_fails_without_cards():
    proc = run_python("import runpy, sys; sys.argv = ['multicard_smoke.py']; "
                      "runpy.run_path('scripts/multicard_smoke.py', run_name='__main__')")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert '"ok": true' not in proc.stdout
