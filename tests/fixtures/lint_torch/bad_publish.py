"""Fixture: direct rename publishes outside atomic_commit are flagged."""
import os


def atomic_commit(path, data):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)          # sanctioned: the one publish helper


def sloppy_publish(path, data):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)          # BAD: no fsync before rename


def sloppy_rename(src, dst):
    os.rename(src, dst)            # BAD: same, via os.rename
