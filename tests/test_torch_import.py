"""The port imports without JAX and builds nothing at import time."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every driver of examples_torch/, the JAX examples' but the adjoint one
DRIVERS = sorted(
    [f"examples_torch/2d/{name}.py" for name in
     ("adjoint_viscosity_inversion", "flow_past_cylinder", "flow_past_rod",
      "lamb_oseen_vortex")]
    + [f"examples_torch/3d/{name}.py" for name in
       ("flow_past_freely_rotating_rod", "flow_past_rod",
        "flow_past_sphere", "point_source_advect_diffuse",
        "rod_and_sphere", "sedimenting_sphere")])


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import sopht_mpi_tpu_torch, sopht_mpi_tpu_torch.cases\n"
        "import sopht_mpi_tpu_torch.convert\n"
        "import sopht_mpi_tpu_torch.models.elastica\n"
        "import sopht_mpi_tpu_torch.models.immersed_body.rod_forcing_grids\n"
        "from sopht_mpi_tpu_torch.models import build_rod_fsi_step\n"
        "from sopht_mpi_tpu_torch.models import build_multi_body_fsi_step\n"
        "from sopht_mpi_tpu_torch.models import rigid_body\n"
        "from sopht_mpi_tpu_torch.ops.poisson import resolve_fast_spectral\n"
        "from sopht_mpi_tpu_torch.convert import multi_body_fsi_carry_from_numpy\n"
        "from sopht_mpi_tpu_torch import enable_fast_spectral\n"
        "from sopht_mpi_tpu_torch.models import UnboundedFlowSimulator2D\n"
        "from sopht_mpi_tpu_torch.models import Cylinder\n"
        "from sopht_mpi_tpu_torch.ops import stencils_2d\n"
        "from sopht_mpi_tpu_torch.ops.poisson import UnboundedPoissonSolver2D\n"
        "from sopht_mpi_tpu_torch.cases import lamb_oseen_vortex_case\n"
        "import sopht_mpi_tpu_torch.tools.probe_edge_passes\n"
        "from sopht_mpi_tpu_torch.ops import cuda_stencils_3d\n"
        "from sopht_mpi_tpu_torch.ops import cuda_stencils_3d_sharded\n"
        "from sopht_mpi_tpu_torch.parallel import mesh, collectives\n"
        "from sopht_mpi_tpu_torch.parallel import distributed, fft\n"
        "from sopht_mpi_tpu_torch.parallel import windows\n"
        "from sopht_mpi_tpu_torch.cases import dryrun_multichip\n"
        "from sopht_mpi_tpu_torch.cases import sharded_flow_case\n"
        "import sopht_mpi_tpu_torch.tools.probe_sharded\n"
        "import bench_torch\n"
        "from sopht_mpi_tpu_torch.parallel import cuda_fft\n"
        "import sopht_mpi_tpu_torch.utils as u\n"
        "from sopht_mpi_tpu_torch.utils import checkpoint, io, native_io\n"
        "from sopht_mpi_tpu_torch.utils import plotting, profiling, snapshots\n"
        "import importlib.util, glob\n"
        "paths = sorted(glob.glob('examples_torch/*/*.py'))\n"
        f"assert paths == {DRIVERS}, paths\n"
        "for path in paths:\n"
        "    spec = importlib.util.spec_from_file_location('ex', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import sopht_mpi_tpu_torch.tools.probe_determinism\n"
        "assert 'h5py' not in sys.modules, 'h5py imported'\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'sopht_mpi_tpu' not in sys.modules, 'JAX package imported'\n"
        "assert cuda_stencils_3d.library.cache_info().currsize == 0\n"
        "assert cuda_fft.library.cache_info().currsize == 0\n"
        "assert native_io.library.cache_info().currsize == 0\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "bench_torch.py")
    for top in ("sopht_mpi_tpu_torch", "examples_torch"):
        for dirpath, _, files in os.walk(os.path.join(REPO, top)):
            for name in files:
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


def test_port_sources_name_no_jax():
    """No module of the port or of ``examples_torch/``, nor
    ``chip_smoke.py`` or ``bench_torch.py``, imports JAX or the JAX
    package, lazily or not."""
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for line in f:
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1 \
                        and words[1].split(".")[0] in ("jax", "sopht_mpi_tpu"):
                    offenders.append(f"{path}: {line.strip()}")
    assert not offenders, offenders
