"""Mean time of a request over the window: from the window's start to the
end of its last request, over the requests completed."""


def read(rec):
    return 1e3 * rec.window_s / rec.completed if rec.completed else None
