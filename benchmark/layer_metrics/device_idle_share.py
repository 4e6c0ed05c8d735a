"""Share of the traced part of the window in which no kernel, copy or set
ran on the card, in percent."""


def read(rec):
    dt = rec.get("devtrace")
    if not dt or dt["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dt["busy_s"] / dt["window_s"])
