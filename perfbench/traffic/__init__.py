"""One module a kind of traffic, each with its ``Traffic``; a workload file
names its kind (``workloads/<cell>.json``)."""
