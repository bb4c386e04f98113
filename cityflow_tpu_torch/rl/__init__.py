"""RL surface of the port: the batched envs (rl/env.py: CityFlowVecEnv on
the gen-1 step, RingVecEnv on the ring) with their MaxPressure controllers
(rl/policies.py for gen-1), and the DQN learners (rl/dqn.py for gen-1,
rl/ring_dqn.py for the ring; both over rl/dqn.py's Q-network and
update)."""
