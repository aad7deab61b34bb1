# Model layers of the port: the shared dense layers (layers), the
# recsys serving models DLRM and DeepFM over the B6 EmbeddingBag
# (recsys), NequIP inference with its message sums on B7 (nequip), and
# the dense GQA decoder (attention, transformer) whose paged decode runs
# B8.
# Parameters keep the JAX package's layouts, so a carried parameter
# tree (repro_torch.carry) computes the same function.
