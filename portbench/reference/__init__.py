"""The plain reference: nvblox's mapping semantics in plain PyTorch and
NumPy on dense voxel grids. It imports nothing of the program under test.
"""
