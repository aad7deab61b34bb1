# Model layers of the port: the shared dense layers (layers) and the
# recsys serving models DLRM and DeepFM over the B6 EmbeddingBag
# (recsys).  Parameters keep the JAX package's layouts, so a carried
# parameter tree (repro_torch.carry) computes the same function.
