"""One driver per app, named by a configuration's ``app`` key.

A driver module gives ``App(cfg, traffic, seed, device)`` with:

* ``warm(ex)``: the set-up's one pass, through the same entry as a job;
* ``job(ex, index)``: one job through the program's public entry, returning
  ``(passes, reports)``; it keeps what the comparison needs of the last job;
* ``reference(control)``: the plain reference's answer to the last job, in
  the configuration's precision, or with ``control`` in the next one below;
* ``compare(answer, reference)``: each number compared, by name;
* ``answer()``: the program's answer to the last job.
"""
