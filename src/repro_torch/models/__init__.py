# Model layers of the port: the shared dense layers (layers), the
# recsys serving models DLRM and DeepFM over the B6 EmbeddingBag
# (recsys), NequIP inference with its message sums on B7 (nequip), and
# the LM decoder (attention, moe, transformer): GQA, whose paged decode
# runs B8, MLA, MoE and dense-residual MoE.
# Parameters keep the JAX package's layouts, so a carried parameter
# tree (repro_torch.carry) computes the same function.
