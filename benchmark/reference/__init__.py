"""The benchmark's plain reference: float64 NumPy / SciPy plane-stress
elements (`plane_stress`) and the judgement of a solved load case
(`judge`). It imports nothing of the program under test."""
