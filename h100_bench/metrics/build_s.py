"""Host seconds of the program's operator build from the benchmark's
input (``problems/<problem>.py:program_operator``: ``as_operator``'s auto
route, RCM and ELL packing; the ``SymDiaOperator`` of a band), to the
card's having finished it."""


def read(obs):
    return obs["build_s"]
