"""The plain PyTorch f32 reference of the VSR model, its loss and its
optimizer. It imports nothing of the port and takes nothing the port made:
the benchmark hands it the weights and inputs that it handed the port."""
