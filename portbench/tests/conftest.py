import torch

# the tests' graphs are tiny: more threads only contend with the other workers
torch.set_num_threads(2)
