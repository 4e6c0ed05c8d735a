"""Dispatch to host sync of each chunk's serving step, in ms: the flight
recorder's ``chunk_ms`` summed over the window's chunks, over the
chunks."""


def read(rec):
    fl = rec["flight"]
    return sum(f["chunk_ms"] for f in fl) / len(fl) if fl else None
