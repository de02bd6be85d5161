"""Set-up time: process start to the window's open (loading, the card's
start-up, kernel builds on a checkout's first run, making the data, the
anchor and the warm-up), host clock."""


def read(rec):
    return rec["setup_s"]
