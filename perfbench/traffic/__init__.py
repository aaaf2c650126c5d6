"""Traffic of the benchmark: one generator (:mod:`markov`) and one data
file a mix (``<name>.json``)."""
