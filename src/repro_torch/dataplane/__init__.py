# Domain datacubes and request populations (weather), the synthetic
# click and interaction streams the recsys models serve (recsys), and
# the graphs, sampled minibatches and molecule batches NequIP serves
# (graph).
