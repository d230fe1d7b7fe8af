"""Time the doubling slice round of a checkout on the card, end to end:
``bench_unif_graph.py``'s doubling and doubling-balls drives (the 3-D
correlated Gaussian with ``RSliceSampler(slice_doubling=True)``, bounds
'single' at nlive 500 and 'balls' at nlive 2048), with its options and
its records: wall, ``Timings['dispatch']``, the flag reads
(``sync_slice``) and the dispatch ms a read, the run's counts and the
device's idle share.

    python3 bench_doubling_graph.py [--root DIR] [--out FILE] [--no-profile]
                                    [--drives doubling,doubling-balls]
"""

from bench_unif_graph import main

if __name__ == "__main__":
    main("bench_doubling_graph", "doubling,doubling-balls")
