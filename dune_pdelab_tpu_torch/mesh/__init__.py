from dune_pdelab_tpu_torch.mesh.adaptive import AdaptiveMesh  # noqa: F401
from dune_pdelab_tpu_torch.mesh.simplex import SimplexMesh  # noqa: F401
from dune_pdelab_tpu_torch.mesh.structured import StructuredMesh  # noqa: F401
