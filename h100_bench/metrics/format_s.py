"""Host seconds of ``choose_format``'s diagonal count and the probes it
leads to, in the operator build (the program's counter ``format_s``; the
RCM probe is ``rcm_s``)."""

from h100_bench.metrics._counted import value


def read(obs):
    return value("format_s")
