"""solves_per_s: instances solved (status optimal) over the whole window,
divided by the window's time from its first call to its last completion
(host clock).  An instance not solved counts for nothing."""


def read(rec):
    return rec.solved / rec.window_s
