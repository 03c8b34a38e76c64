"""Host seconds of the ELL storage's sort and packing in the operator
build (the program's counter ``ell.pack_s``, ``build_ell``)."""

from h100_bench.metrics._counted import value


def read(obs):
    return value("ell.pack_s")
