"""Reinforcement learning: PPO's policy, GAE and update (rl/ppo.py)."""
