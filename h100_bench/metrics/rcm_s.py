"""Host seconds of the reverse Cuthill-McKee probe in the operator build
(the program's counter ``rcm_s``: scipy's ``reverse_cuthill_mckee`` and the
reordered bandwidth, once for the matrix)."""

from h100_bench.metrics._counted import value


def read(obs):
    return value("rcm_s")
