"""The port's benchmark: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``portbench/run.py``)."""
