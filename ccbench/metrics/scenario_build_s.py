"""Host seconds the program took to build the cell's grid from its specs
(fabric, route table, every point's scenario tensors): ``Sweep(...)`` over
``ScenarioSpec`` values, timed in set-up."""


def read(rec):
    return rec["scenario_build_s"]
