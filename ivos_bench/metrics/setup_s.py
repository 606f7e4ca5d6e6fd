"""Set-up seconds: import, weights and clips on the card, the program's
networks, the kernel library, the warm session."""


def read(run):
    return run.setup_s
