"""How a traffic mix drives the port. A mix's data file names its loop
(``"loop"``); ``portbench/loops/<loop>.py`` runs it with ``run(...)`` and
returns the run's record (``portbench/harness.py`` says what it holds)."""
