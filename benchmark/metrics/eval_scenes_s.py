"""Scenes scored per second by the eval graph, batches already on the card:
the scenes of every eval step the window finished over the window's whole
time (host clock, ended by a synchronize)."""


def read(record):
    if record["phase"] != "eval" or record["driver"] != "resident":
        return None
    return record["scenes"] / record["window_s"]
