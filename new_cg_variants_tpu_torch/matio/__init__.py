"""MatrixMarket I/O, the native coordinate reader and the model problems."""

from .matrix_market import CooMatrix, load_matrix, matrix_path, read_mtx, write_mtx
from .problems import (
    banded_model,
    banded_model_diagonal,
    model_spectrum,
    model_spectrum_eigenvalues,
)
