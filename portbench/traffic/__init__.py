"""One module per kind of traffic, named by a workload file's ``kind``.
Each has ``prepare(run)`` (set-up and warm-up), ``client(run, c)`` (one
closed-loop client of the window), ``collect(run)`` (what the program
produced, gathered once the window has closed, the cluster still up) and
``judge(run, evidence)`` (the plain reference's verdict, after the
cluster stopped: name -> (number, limit))."""
