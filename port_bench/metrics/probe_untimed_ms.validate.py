"""Milliseconds of a validation in the probes' runs that no measurement
times: the HBM leg's checksum-gated launches (``hbm.gate``) and the matmul
warm-up chains (``matmul.warmup``) inside each traced
``validator.validate`` span, averaged over the traced validations. The
guarantees fix their work, so it falls only as those runs get faster, and
each millisecond it falls is one of ``validate_s``."""

from port_bench.program_spans import inside_us, spans


def read(run):
    outer = spans(run, "validator.validate")
    if not outer:
        return None
    untimed = sorted(spans(run, "hbm.gate") + spans(run, "matmul.warmup"),
                     key=lambda s: s.start)
    per = inside_us(outer, untimed)
    return sum(per) / len(per) / 1e3
