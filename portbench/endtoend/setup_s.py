"""setup_s: from the harness's start to the window's: imports, the card's
context, the first run's kernel and host-library builds, the read sets,
the base (where the mix has one) and the warm-up op."""

UNIT = "s"


def read(window):
    return window.setup_s
