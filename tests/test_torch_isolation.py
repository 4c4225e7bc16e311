"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU fallback --
in the package and in its examples (``examples/port_*.py``)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import raid as traid
from repro_torch.core.array import ZapRAIDArray, ZapRaidConfig
from repro_torch.core.zns import ZnsConfig

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"
EXAMPLES = SRC.parent / "examples"


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_importing_every_module_loads_no_jax_and_no_repro():
    names = [name for _, name in _modules()]
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(len(sys.modules)); assert not bad, bad\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized(), 'importing a module started a process group'\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _assert_no_jax_or_repro_imports(path, name):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), (name, mod)


@pytest.mark.parametrize("path,name", list(_modules()), ids=lambda v: str(v))
def test_no_jax_or_repro_imports_in_source(path, name):
    _assert_no_jax_or_repro_imports(path, name)


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("port_*.py")), ids=lambda p: p.name)
def test_no_jax_or_repro_imports_in_port_examples(path):
    _assert_no_jax_or_repro_imports(path, path.name)


def test_default_device_is_cuda_and_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ZapRaidConfig.__dataclass_fields__["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ZapRaidConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traid.StripeCodec(traid.make_scheme("raid6", 4))
    with pytest.raises(ValueError):
        ZapRaidConfig(device="meta")
    cfg = ZapRaidConfig(device="cpu")  # asking for the CPU is the only way there
    arr = ZapRAIDArray(cfg, ZnsConfig(n_zones=8, zone_cap_blocks=64, block_bytes=256))
    assert arr.codec.device.type == "cpu"


def test_sharding_entry_points_default_to_the_card(monkeypatch):
    """``make_host_mesh`` and the dry run default to the card and raise
    without a GPU; asking for the CPU is the only way there."""
    import inspect

    from repro_torch.launch import dryrun, mesh

    assert inspect.signature(mesh.make_host_mesh).parameters["device_type"].default == "cuda"
    assert inspect.signature(dryrun.run_cell).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k", "--out", "unused"])


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("port_*.py")), ids=lambda p: p.name)
def test_port_examples_default_to_the_card(path, monkeypatch):
    """Every port example takes ``--device``, ``cuda`` unless the CPU is asked
    for, and raises without a GPU."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
