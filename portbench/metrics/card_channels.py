"""``card_channels``: stations x steps completed / window seconds, with
the band resident on the card (the window ends when the card has run
every step the host queued in it)."""


def read(run):
    if run["loop"] != "resident":
        return None
    return run["stations"] * run["steps"] / run["window_s"]
