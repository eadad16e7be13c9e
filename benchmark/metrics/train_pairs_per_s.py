"""Contrastive pairs of every dispatch submitted in the window, over the
time from the window's start to the synchronization after the last."""


def read(rec):
    if rec.get("kind") != "pretrain" or not rec.get("window_s"):
        return None
    return rec["pairs"] / rec["window_s"]
