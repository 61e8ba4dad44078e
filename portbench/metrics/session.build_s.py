"""Wall seconds of ``Session.build``: the (C', lambda) calibration, the
plan and the state made on the device."""
UNIT, LAYER, MOVES = "s", "front door", "setup_s"


def read(rec):
    return rec.get("build_s")
