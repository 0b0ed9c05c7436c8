import sys

from .runner import main

main(sys.argv[1:])
