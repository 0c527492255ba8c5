"""Plain references of the benchmark: they import nothing of the program.

  data.py       the class-prototype generator and the thermometer
                booleanizer (frozen copies of the port's, on any device)
  classsums.py  class sums straight from include actions
"""
