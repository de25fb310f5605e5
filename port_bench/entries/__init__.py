"""The entries: each builds the system under test from a configuration and
runs one unit of its work.

An entry module ``<name>.py`` holds a ``Session(config, traffic, seed,
devices, spans)`` with ``cuda`` (whether it runs on the card), ``warm()``
(set-up's one pass of the cell's own shapes, leaving no answers behind),
``step()`` (one unit, with no wait for the device of its own: the loop
waits as the traffic mix says; False for a unit that failed), ``sync()``,
``free()`` (the program's state dropped, the answers kept),
``compare(control=False)`` (the numbers that decide ``correct``, from the
reference; with ``control``, the reference in a lower precision in the
program's place) and ``close()``.
"""
