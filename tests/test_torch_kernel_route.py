"""The one rule by which a prefill takes a forward-only CUDA kernel
(``kernels/route.py``) and the wrappers that ask it: ``kernels/attention.py``
``takes`` for ``models/layers.py prefill_attention`` and
``kernels/mamba_glue.py`` ``takes`` for ``models/mamba2.py mamba_apply``.

On the CPU every operand takes the plain version, bit for bit, and launches
nothing.  The tests marked ``cuda`` need an NVIDIA GPU and skip without
one: at each prefill cell's layer widths (few layers, small B and T), and
for the smoke zamba2 model in bf16 (head dim 16), every Mamba-2 block
launches each glue kernel once and every attention application one
attention kernel.  The file imports neither JAX nor ``repro``.  Run the
card's tests with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_route.py
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F
from test_torch_attention_kernel import _attention, _blocked_apply
from test_torch_mamba_fused import _block, _equal, _plain_apply

from repro_torch.configs import get_config
from repro_torch.kernels import attention, launch_counts, mamba_glue, reset_launch_counts
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.config import smoke
from repro_torch.models.model import build_model

# (operator, mode): what each CPU case runs; ``weight_grad`` has one weight
# that the kernel's operands depend on require grad, and nothing else;
# ``scan_grad`` the same with A's log, which the scan between the glue
# kernels reads.
CPU_CASES = [("attention", m) for m in ("float32", "bfloat16", "recorded", "weight_grad")] + \
    [("mamba", m) for m in ("float32", "bfloat16", "recorded", "weight_grad", "scan_grad",
                            "decode", "ragged")]

# Each prefill cell's model at its published widths, cut in depth: one
# attention application where the cell has attention.  ``zamba2_smoke`` is
# ``smoke()``'s zamba2 in bf16, at head dim 16.
CELLS = {
    "mamba2": lambda: dataclasses.replace(get_config("mamba2-1.3b"), n_layers=2),
    "zamba2": lambda: dataclasses.replace(get_config("zamba2-2.7b"), n_layers=6),
    "granite": lambda: dataclasses.replace(
        get_config("granite-4.0-h-small"), n_layers=3,
        layer_types=("mamba", "attention", "mamba"), n_experts=8, top_k=2),
    "zamba2_smoke": lambda: smoke(get_config("zamba2-2.7b"), dtype="bfloat16"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _requires_grad(p: dict, mode: str, weight: str) -> bool:
    """Set ``requires_grad`` on ``p``'s weights as ``mode`` asks; whether
    autograd records."""
    for name, w in p.items():
        w.requires_grad_(mode == "recorded" or (mode.endswith("_grad") and name == weight))
    return mode in ("recorded", "weight_grad", "scan_grad")


# ------------------------------------------------------------------- CPU

@pytest.mark.parametrize("op,mode", CPU_CASES)
def test_cpu_operands_take_the_plain_version(op, mode):
    """On CPU tensors -- float32, bf16 under no_grad, a recorded graph,
    one weight requiring grad, and for the Mamba-2 block a decode step and
    a T ragged against the chunk -- neither wrapper's ``takes`` holds, and
    attention runs the blocked function and the block its plain chain, bit
    for bit, launching nothing."""
    dtype = "float32" if mode == "float32" else "bfloat16"
    if op == "attention":
        cfg, p, x, pos = _attention(dtype, 80, "cpu")
        recorded = _requires_grad(p, mode, "wq")
        reset_launch_counts()
        with torch.set_grad_enabled(recorded):
            q, k, v = L._qkv(p, x, cfg)
            assert not attention.takes(q, k, v)
            out, new = L.attention_apply(p, x, cfg, positions=pos)
            want, want_new = _blocked_apply(p, x, cfg, pos)
    else:
        cfg = smoke(get_config("mamba2-1.3b"), dtype=dtype)
        p, x = _block(cfg, "cpu", 2, {"decode": 1, "ragged": 13}.get(mode, 16))
        state = None
        if mode == "decode":
            ch = cfg.d_inner + 2 * cfg.ssm_state
            state = (torch.randn((2, cfg.ssm_conv - 1, ch)).bfloat16(),
                     torch.randn((2, cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_head_dim)))
        recorded = _requires_grad(p, mode, "a_log" if mode == "scan_grad" else "norm")
        reset_launch_counts()
        with torch.set_grad_enabled(recorded):
            if state is None:
                xs, bb, cc, z = (x @ p[w] for w in ("w_x", "w_b", "w_c", "w_z"))
                dt = F.softplus(x.float() @ p["w_dt"] + p["dt_bias"])
                assert not mamba_glue.takes(xs, bb, cc, z, dt, -torch.exp(p["a_log"]),
                                            p["conv_w"], p["conv_b"], p["d_skip"], p["norm"])
            out, new = M.mamba_apply(p, x, cfg, state=state)
            want, want_new = _plain_apply(p, x, cfg, state=state)
    assert set(launch_counts().values()) == {0}
    assert torch.equal(out, want) and _equal(new, want_new)
    if recorded:
        out.float().sum().backward()
        assert all(w.grad is not None for w in p.values() if w.requires_grad)


# ------------------------------------------------------------------ card

@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(CELLS))
def test_each_cells_widths_launch_one_kernel_a_block(cuda, cell):
    """A bf16 prefill of B 2 and T 200 through the model: each glue kernel
    launches once a Mamba-2 block, the attention kernel once an application,
    and the logits are finite."""
    cfg = CELLS[cell]()
    model = build_model(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 200), generator=gen, device=cuda)
    reset_launch_counts()
    logits, _ = model.prefill(tokens)
    torch.cuda.synchronize()
    counts = launch_counts()
    blocks = cfg.layers_of("mamba") if cfg.layer_types else cfg.n_layers
    assert (model.n_apps > 0) == (cell != "mamba2")
    assert counts["mamba_conv"] == counts["mamba_gate_norm"] == blocks
    assert counts["causal_attention"] == model.n_apps
    assert bool(torch.isfinite(logits.float()).all())
