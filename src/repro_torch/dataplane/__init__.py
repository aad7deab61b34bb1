# Domain datacubes and request populations (weather), the synthetic
# click and interaction streams the recsys models serve (recsys), the
# graphs, sampled minibatches and molecule batches NequIP serves
# (graph), and the LM token corpus read through the extraction service
# (tokens).
