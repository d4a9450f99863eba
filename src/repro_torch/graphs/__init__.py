from repro_torch.graphs.graph import Graph
from repro_torch.graphs import generators
from repro_torch.graphs.convert import graph_from_arrays, to_device

__all__ = ["Graph", "generators", "graph_from_arrays", "to_device"]
