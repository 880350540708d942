"""Models of the port.  The dense GQA transformer LM is ported; the GNN and
recsys models wait for their slice."""
