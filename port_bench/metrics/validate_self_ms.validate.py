"""Milliseconds of a validation outside its legs: each traced
``validator.validate`` span's duration less its ``validator.<leg>``
children's (the runtime build record and the work between legs),
averaged over the traced validations."""

from port_bench.program_spans import VALIDATOR_LEGS, inside_us, spans


def read(run):
    outer = spans(run, "validator.validate")
    if not outer:
        return None
    legs = sorted((s for name in VALIDATOR_LEGS for s in spans(run, name)),
                  key=lambda s: s.start)
    selfs = [o.end - o.start - inner
             for o, inner in zip(outer, inside_us(outer, legs))]
    return sum(selfs) / len(selfs) / 1e3
