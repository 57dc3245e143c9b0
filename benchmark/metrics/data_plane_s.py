"""``data_plane_s``: seconds of the set-up's data plane (the program's
``io/sources``, ``io/points``, ``io/gridsource`` and ``io/driver`` reading
and merging the cell's input files), the harness's span around those
calls.  Moves ``setup_s``."""


def read(r):
    return r.spans.get("data_plane")
