# Domain datacubes and request populations (weather), and the synthetic
# click and interaction streams the recsys models serve (recsys).
