"""The adjoint viscosity inversion driver
(``examples_torch/2d/adjoint_viscosity_inversion.py``) against the JAX
package's example, on the CPU.

- At the JAX smoke settings of ``test_example_smoke.py`` ((32, 32), 60
  steps, 16 iterations, learning rate 0.2, float64): the loss history
  within 1e-10 relative of the JAX example's, nu recovered to 5%.
- The first value and gradient in float32 on the 2D kernel route (the
  three pass wrappers, forced on the CPU) against float64 on the dense
  ``torch.fft`` route: relative gap at most 1e-3 (measured on the CPU:
  3.2e-7 for the gradient, 7.2e-7 for the value).
- The command line refuses a missing card.
"""

import importlib.util
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = dict(grid_size=(32, 32), n_steps=60, iters=16, learning_rate=0.2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the rollout loops over many small ops, which
    gain nothing from more threads on the CPU and stall on thread barriers
    when other test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(package_dir):
    prefix = "port" if package_dir == "examples_torch" else "jax"
    path = os.path.join(REPO, package_dir, "2d",
                        "adjoint_viscosity_inversion.py")
    spec = importlib.util.spec_from_file_location(f"{prefix}_2d_adjoint",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    if package_dir == "examples":
        # the JAX example imports its sibling lamb_oseen_vortex
        sys.path.insert(0, os.path.dirname(path))
    try:
        spec.loader.exec_module(module)
    finally:
        if package_dir == "examples":
            sys.path.remove(os.path.dirname(path))
    return module


def test_loss_history_matches_the_jax_example():
    port = _load("examples_torch")
    nu_rec, nu_true, rel_err, history = port.adjoint_viscosity_inversion_case(
        **SMOKE, device="cpu")
    jnu, _, jrel, jhistory = _load("examples") \
        .adjoint_viscosity_inversion_case(**SMOKE)
    assert len(history) == len(jhistory) == SMOKE["iters"] + 1
    gap = np.abs(np.asarray(history) - np.asarray(jhistory)) / np.abs(
        np.asarray(jhistory))
    assert gap.max() <= 1e-10, gap.max()
    assert rel_err < 0.05 and history[-1] < history[0]
    assert nu_rec == pytest.approx(jnu, rel=1e-10)
    assert rel_err == pytest.approx(jrel, rel=1e-8, abs=1e-12)


def test_cosine_decay_is_optax_formula():
    port = _load("examples_torch")
    decay = port.cosine_decay(16)
    assert decay(0) == 1.0 and decay(16) == 0.0 and decay(40) == 0.0
    assert decay(4) == pytest.approx(0.5 * (1 + math.cos(math.pi / 4)))


def _value_and_grad(port, precision):
    loss_fn, real_t = port.build_inversion(
        SMOKE["grid_size"], 1e-3, SMOKE["n_steps"], precision, device="cpu")
    log_nu = torch.tensor(math.log(2e-3), dtype=real_t, requires_grad=True)
    val = loss_fn(log_nu)
    (grad,) = torch.autograd.grad(val, log_nu)
    return float(val.detach()), float(grad)


def test_float32_kernel_route_gradient_matches_float64(monkeypatch):
    from sopht_mpi_tpu_torch.ops import poisson
    from sopht_mpi_tpu_torch.parallel import cuda_fft

    port = _load("examples_torch")
    ref_val, ref_grad = _value_and_grad(port, "double")
    monkeypatch.setattr(poisson, "FORCE_KERNEL_CONVOLVE", True)
    calls = []
    for name in ("RfftPassPaddedSplitFn", "FftGreensIfftPassFn",
                 "IrfftPassMergeFn"):
        fn = getattr(cuda_fft, name)
        monkeypatch.setattr(fn, "apply", (
            lambda apply, name: lambda *a: calls.append(name) or apply(*a))(
                fn.apply, name))
    val, grad = _value_and_grad(port, "single")
    # each rollout step solves once, through the three passes' Functions
    for name in ("RfftPassPaddedSplitFn", "FftGreensIfftPassFn",
                 "IrfftPassMergeFn"):
        assert calls.count(name) == SMOKE["n_steps"], name
    assert abs(val - ref_val) <= 1e-3 * abs(ref_val)
    assert abs(grad - ref_grad) <= 1e-3 * abs(ref_grad), (grad, ref_grad)


def test_command_line_needs_a_card():
    script = os.path.join(REPO, "examples_torch", "2d",
                          "adjoint_viscosity_inversion.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, script], capture_output=True,
                          text=True, env=env, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
