"""Sampled read windows taken through whole adaptFinder runs a second:
every pass of every job that started in the window and ended with exit
code 0 counts its windows (``n_valid``), over the window's seconds, which
hold the parse, the engine, the graphs' capture, the passes and the
exports of every job."""


def read(run):
    done = sum(j.rc == 0 for j in run.jobs)
    return done * len(run.passes) * run.windows_per_pass / run.window_s
