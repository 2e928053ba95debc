from .abd import AbdModel, AbdSolverCfg, AbdState  # noqa: F401
from .coupled import CoupledModel  # noqa: F401
from .fem import lame_params, stable_neo_hookean_energy  # noqa: F401
from .ipc import IpcSolverCfg, RigidSdfScene, SoftBodyModel, SoftBodyState  # noqa: F401
from .mesh import TetMesh, box_tet_mesh, extract_surface, isosurface_stuffing_tet_mesh, voxel_tet_mesh  # noqa: F401
from .msh_io import load_msh  # noqa: F401
