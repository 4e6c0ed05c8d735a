"""Host work before each chunk's dispatch (admission, packing), in ms:
the flight recorder's ``host_ms`` summed over the window's chunks, over
the chunks."""


def read(rec):
    fl = rec["flight"]
    return sum(f["host_ms"] for f in fl) / len(fl) if fl else None
