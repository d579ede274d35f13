"""Input and output: VTK writers (ASCII, native binary, .pvd, .pvtu), the
DGF reader and the native MSH parser (PyTorch port of dune_pdelab_tpu/io/)."""
from dune_pdelab_tpu_torch.io.dgf import read_dgf
from dune_pdelab_tpu_torch.io.vtk import (
    ParallelVTKWriter, VTKSequenceWriter, VTKWriter,
)

__all__ = ["VTKWriter", "VTKSequenceWriter", "ParallelVTKWriter", "read_dgf"]
