"""RL surface of the port: the batched ring env (rl/env.RingVecEnv) with its
MaxPressure controller, and the ring DQN learner (rl/ring_dqn.py over the
Q-network of rl/dqn.py)."""
