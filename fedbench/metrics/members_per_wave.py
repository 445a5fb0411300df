"""Members trained per wave of the cohort engine: the window's client
updates over every lane, over the waves the engine trained
(``SimResult.dispatches`` and ``cohorts``)."""


def read(rec):
    waves = sum(s["cohorts"] for s in rec["sims"])
    if waves == 0:
        return None
    return sum(s["dispatches"] * s["lanes"] for s in rec["sims"]) / waves
