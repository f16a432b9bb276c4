"""100 * (1 - busy / window): the share of the traced window in which no
operation ran on the card, from the same union of intervals as
``device.busy_s`` (means over the cards)."""


def read(run):
    if run.trace is None or not run.trace["busy_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
