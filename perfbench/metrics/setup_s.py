"""setup_s: seconds from the process's start to the first timed unit:
imports, the card, weights and pool from the seed, the checked steps, the
warm-up, and in a checkout's first run the builds (host clock)."""


def read(run):
    return run.setup_s
