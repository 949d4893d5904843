"""The benchmark's yardstick: the card's peaks and the work formulas,
frozen here so that a later change to the program cannot move them.  A CPU
test holds each frozen copy equal to the program's formula it was copied
from, at the cells' shapes; where the program's formula changes, that test
says so and the copy stays."""
