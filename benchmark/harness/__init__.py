"""The benchmark's general code: finding a cell's files (`spec`), the
program's inputs (`inputs`, `loadcase`), one run (`core`), the traced
stretch (`trace`) and the card's peaks (`yardstick`)."""
