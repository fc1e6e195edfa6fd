"""The port's dataset tooling: the audio stage (and the habitat-gated
render stage) of dataset generation, and the sound-navigation tasks;
counterparts of the repository's ``dataset/`` scripts."""
