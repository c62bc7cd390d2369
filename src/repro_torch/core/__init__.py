"""The DC-v suffix-array algorithms of the port: the numpy references
(`difference_cover`, `oracle`, `seq_ref`) and the PyTorch build
(`dcv_torch`)."""
