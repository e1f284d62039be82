"""From the process's start to the first timed request."""


def read(rec):
    return rec.setup_s
