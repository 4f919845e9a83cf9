"""Port of ``repro.fl``: the learning-coupled engine, FedAvg aggregation
and the accuracy-versus-time metrics."""
