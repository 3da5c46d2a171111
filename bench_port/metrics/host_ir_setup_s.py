"""Host seconds of the port's ``build_graph_memory`` (placement,
criticality, packing) for every layout the cell's calls use, taken in
set-up."""


def read(ctx):
    return ctx["host_ir_setup_s"]
