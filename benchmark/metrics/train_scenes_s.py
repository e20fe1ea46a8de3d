"""Scenes trained per second by the step graphs, batches already on the
card: the scenes of every train step the window finished over the window's
whole time (host clock, ended by a synchronize)."""


def read(record):
    if record["phase"] != "train" or record["driver"] != "resident":
        return None
    return record["scenes"] / record["window_s"]
