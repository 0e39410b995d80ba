"""The benchmark's yardstick: Pisinger's instance classes and capacity
series, and the plain optimum.  Imports nothing of the program."""
