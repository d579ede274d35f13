from dune_pdelab_tpu_torch.mesh.structured import StructuredMesh  # noqa: F401
