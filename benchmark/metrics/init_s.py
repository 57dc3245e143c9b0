"""``init_s``: seconds of the set-up's production init (the expanders,
the CheckValues screen, the coupling windows, the relaxation anchors and
the initial state), the harness's span around those calls.  Moves
``setup_s``."""


def read(r):
    return r.spans.get("init")
